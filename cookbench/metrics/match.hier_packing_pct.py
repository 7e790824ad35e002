"""The two-level pools' packing against the plain greedy, in %: as
`match.packing_pct`, over the pools whose window takes the hierarchical
path; nothing where no pool does."""


def read(run):
    value = run.packing.get("hierarchical")
    return None if value is None else 100.0 * value
