"""Controller and odometry."""
