"""Multi-device mesh mode (port of reindexer_tpu/parallel/): row-sharded
index state over a list of torch devices and the per-shard top-k merges."""
