"""What a wrapper call pays for between its checks and its kernel's
launcher: the inputs as the launcher reads them, the device index and the
stream.  Shared by the search kernels' wrappers (imc_eval, ga_gen_step)."""
from __future__ import annotations

import torch


def contiguous(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous ``dtype`` tensor: ``t`` itself when it is one."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def cuda_index(dev: torch.device) -> int:
    """The CUDA device index of ``dev`` (the current device for "cuda")."""
    return torch.cuda.current_device() if dev.index is None else dev.index


def stream(index: int) -> int:
    """The handle of PyTorch's current stream on CUDA device ``index``
    (the raw handle, without the ``torch.cuda.Stream`` object that
    ``torch.cuda.current_stream`` builds: a fraction of a microsecond
    against several; ``chip_smoke.py``'s host split, PERF.md)."""
    return torch._C._cuda_getCurrentRawStream(index)
