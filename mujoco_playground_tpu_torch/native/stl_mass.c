/* Binary STL parsing + rigid-body mass properties.
 *
 * The port's copy of the JAX package's native/stl_mass.c: native twin of
 * the mesh-processing stage of MuJoCo's C model compiler.  Exposed via
 * ctypes (native/__init__.py); model compilation is host-side and happens
 * once, but large mesh libraries make it worth native speed.
 *
 * Algorithm: signed-tetrahedron accumulation (divergence theorem) over the
 * triangle soup, yielding volume, center of mass, and the inertia tensor
 * about the CoM for uniform density (MuJoCo's "exact" mesh inertia).
 *
 * Build (native/__init__.py does it at first use, into build/native/):
 *   cc -O2 -shared -fPIC -o libstl_mass-<hash>.so stl_mass.c
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
  double volume;      /* signed volume */
  double com[3];      /* center of mass */
  double inertia[9];  /* inertia tensor about the CoM, unit density */
  double aabb[6];     /* min xyz, max xyz */
  int32_t n_triangles;
} MassProps;

/* Accumulate one tetra (origin, a, b, c) into integrals.
 * integ: [vol, x, y, z, xx, yy, zz, xy, yz, zx] */
static void accumulate(const double *a, const double *b, const double *c,
                       double *integ) {
  /* signed volume of tetra (0, a, b, c) */
  double det = a[0] * (b[1] * c[2] - b[2] * c[1]) -
               a[1] * (b[0] * c[2] - b[2] * c[0]) +
               a[2] * (b[0] * c[1] - b[1] * c[0]);
  double vol = det / 6.0;
  integ[0] += vol;
  /* centroid of tetra = (a+b+c)/4 (origin contributes 0) */
  for (int i = 0; i < 3; i++) integ[1 + i] += vol * (a[i] + b[i] + c[i]) / 4.0;
  /* second moments over the tetra: for tetra with vertices 0,a,b,c:
   * integral of x_i x_j = vol/20 * (sum_k sum_l<=k v_k,i v_l,j sym) using
   * the standard formula: V/20 * (a_i a_j + b_i b_j + c_i c_j +
   *   0.5*(a_i b_j + a_j b_i + a_i c_j + a_j c_i + b_i c_j + b_j c_i)) */
  for (int i = 0; i < 3; i++) {
    for (int j = i; j < 3; j++) {
      double s = a[i] * a[j] + b[i] * b[j] + c[i] * c[j] +
                 0.5 * (a[i] * b[j] + a[j] * b[i] + a[i] * c[j] +
                        a[j] * c[i] + b[i] * c[j] + b[j] * c[i]);
      double val = vol / 10.0 * s;
      int idx;
      if (i == j) idx = 4 + i;               /* xx, yy, zz */
      else if (i == 0 && j == 1) idx = 7;    /* xy */
      else if (i == 1 && j == 2) idx = 8;    /* yz */
      else idx = 9;                          /* zx */
      integ[idx] += val;
    }
  }
}

static void finish(double *integ, MassProps *out) {
  double vol = integ[0];
  out->volume = vol;
  if (vol == 0.0) vol = 1e-300;
  for (int i = 0; i < 3; i++) out->com[i] = integ[1 + i] / vol;
  double xx = integ[4], yy = integ[5], zz = integ[6];
  double xy = integ[7], yz = integ[8], zx = integ[9];
  /* shift second moments to CoM */
  const double *c = out->com;
  xx -= vol * c[0] * c[0];
  yy -= vol * c[1] * c[1];
  zz -= vol * c[2] * c[2];
  xy -= vol * c[0] * c[1];
  yz -= vol * c[1] * c[2];
  zx -= vol * c[2] * c[0];
  /* inertia tensor (unit density) */
  out->inertia[0] = yy + zz;
  out->inertia[4] = xx + zz;
  out->inertia[8] = xx + yy;
  out->inertia[1] = out->inertia[3] = -xy;
  out->inertia[5] = out->inertia[7] = -yz;
  out->inertia[2] = out->inertia[6] = -zx;
}

/* Compute mass properties from an in-memory binary STL buffer. Returns 0 on
 * success. */
int stl_mass_properties(const uint8_t *buf, int64_t len, MassProps *out) {
  if (len < 84) return -1;
  uint32_t n;
  memcpy(&n, buf + 80, 4);
  if ((int64_t)84 + (int64_t)n * 50 > len) return -2;
  double integ[10] = {0};
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  const uint8_t *p = buf + 84 + 12; /* skip normal of first triangle */
  for (uint32_t t = 0; t < n; t++) {
    float v[9];
    memcpy(v, p, 36);
    double a[3] = {v[0], v[1], v[2]};
    double b[3] = {v[3], v[4], v[5]};
    double c[3] = {v[6], v[7], v[8]};
    accumulate(a, b, c, integ);
    for (int k = 0; k < 3; k++) {
      double vals[3] = {a[k], b[k], c[k]};
      for (int m = 0; m < 3; m++) {
        if (vals[m] < lo[k]) lo[k] = vals[m];
        if (vals[m] > hi[k]) hi[k] = vals[m];
      }
    }
    p += 50;
  }
  finish(integ, out);
  for (int k = 0; k < 3; k++) {
    out->aabb[k] = lo[k];
    out->aabb[3 + k] = hi[k];
  }
  out->n_triangles = (int32_t)n;
  return 0;
}

/* File-path convenience wrapper. */
int stl_mass_properties_file(const char *path, MassProps *out) {
  FILE *f = fopen(path, "rb");
  if (!f) return -10;
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  fseek(f, 0, SEEK_SET);
  uint8_t *buf = (uint8_t *)malloc(len);
  if (!buf) { fclose(f); return -11; }
  if (fread(buf, 1, len, f) != (size_t)len) {
    free(buf); fclose(f); return -12;
  }
  fclose(f);
  int rc = stl_mass_properties(buf, len, out);
  free(buf);
  return rc;
}
