"""Device kernels of the port: `common`, `best_node`, `best_block`,
`best_node_batched`, `match`, `hierarchical`, `dru`."""
