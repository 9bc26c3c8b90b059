"""Full-scene tiled inference with on-device stitching."""
