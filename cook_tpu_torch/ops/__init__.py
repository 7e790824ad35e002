"""Device kernels of the port: `common`, `best_node`, `match`, `dru`."""
