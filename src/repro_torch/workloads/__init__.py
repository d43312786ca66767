from repro_torch.workloads.cnn import CNN_WORKLOADS, cnn_workload  # noqa: F401
from repro_torch.workloads.pack import WorkloadSet, pack_workloads  # noqa: F401
from repro_torch.workloads.lm import lm_workload  # noqa: F401
