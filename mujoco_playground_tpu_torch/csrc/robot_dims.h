// Compile-time dimensions of the Ackermann robot (spec/robot.py
// ackermann_robot_v2 after welded bodies are fused) that kernels K1 and K2
// are built for.  The Python wrappers read this file and raise when a model
// does not match.  One #define per line: ops/build.py parses them.
#pragma once

#define NQ 13         // qpos: free joint (7) + 6 hinges
#define NV 12         // dofs: free joint (6) + 6 hinges
#define NU 3          // actuators: steering servo, two rear wheel motors
#define NBODY 8       // world + chassis + 6 wheel-chain bodies
#define NJNT 7        // joints
#define NSITE 72      // lidar rangefinder sites
#define NWHEEL 4      // wheel cylinders
#define NHULL 2       // chassis convex hulls
#define NHULLV 36     // hull vertices (padded to a common count)
#define NEQ 1         // joint equality rows (steering coupling)
#define NFRIC 6       // dry-friction rows
#define NJROW 11      // joint rows: NEQ + NFRIC + 2 limited dofs x 2 sides
#define NSLOT 48      // contact slots: 4x4 wheel-plane, 4x4 wheel-box, 2x8 hull
#define DOF_JROWS 4   // joint rows that touch one dof, at most
#define NBDOF 8       // dofs that move one body, at most
#define MAX_BOXES 64  // scene boxes the constant blocks hold
