"""Multi-device layer of the port: so far only `mesh.invalid_match_problem`."""
