"""Multi-process and multi-device execution of the port (graphtyper_tpu/parallel/):
process groups and region and sample sharding over torch.distributed
(distributed.py), device meshes (mesh.py), host-to-device prefetch
(prefetch.py) and the rep-sharded align exchange (rep_shard.py)."""
