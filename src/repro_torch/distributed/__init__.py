"""Contention-aware work placement (`rebalance`), the logical-axis
sharding rules as DTensor placements with the leaf-name convention of
checkpoints (`sharding`), and the elastic restore of a checkpoint onto a
mesh (`elastic`)."""
