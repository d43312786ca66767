"""Energy-delay product, each the worst case over the workload set."""


def score(energy, latency, area):
    return energy * latency
