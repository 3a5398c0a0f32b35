"""The card's route on the CPU: under ``cuda_route()`` every kernel op the
code under test calls runs its CUDA implementation (the dispatcher's own
redispatch to the CUDA key) on the CPU tensors it was given, so a test
that patches a kernel's wrapper sees what a CUDA tensor would reach
there.  ``ops`` lists the ops called, by name."""
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels.ops import NAMESPACE

_CUDA = torch._C.DispatchKeySet(torch._C.DispatchKey.CUDA)


class cuda_route(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == NAMESPACE:
            self.ops.append(func._overloadpacket.__name__)
            return func.redispatch(_CUDA, *args, **kwargs)
        return func(*args, **kwargs)
