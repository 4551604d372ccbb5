"""The distributed plane of the torch port: the padded vertex space, the
partitioned graph, the process group and the exchanges (the ring, and the
all_gather family's per-shard ELL, bsp and blocked tables)."""
