"""Device layer: runtime probe, device meshes, the device sink and the
training-loop shard prefetcher."""
