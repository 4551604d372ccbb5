"""The distributed plane of the torch port: the padded vertex space, the
partitioned graph, the process group (and the 2D mesh's grid of it) and the
exchanges (the ring, the all_gather family's per-shard ELL, bsp and blocked
tables, the pipelined ring over blocked step tables, the split mirror)."""
