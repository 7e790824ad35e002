"""Device kernels of the port: `common`, `best_node`, `best_block`,
`best_node_batched`, `coarse_pass`, `match`, `hierarchical`, `dru`,
`rebalance`; `cpu_reference` holds the numpy oracles."""
