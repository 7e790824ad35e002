"""The flat pools' packing against the plain greedy, in %: the demand
the program placed over the demand the reference's greedy places on the
same window and the same free resources (each resource weighed by the
window's mean demand), summed over the judge's sample of window
cycles."""


def read(run):
    value = run.packing.get("flat")
    return None if value is None else 100.0 * value
