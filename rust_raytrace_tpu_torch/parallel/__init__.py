"""Image-tile data parallelism over a list of devices (`sharding`)."""
