"""The paper's joint objective: energy x latency x area, each the worst
case over the workload set."""


def score(energy, latency, area):
    return energy * latency * area
