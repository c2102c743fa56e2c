"""Where an entry point runs: on the card, unless the caller asks for the
CPU by passing a CPU tensor."""
import numpy as np
import torch


def as_input(x, dtype=None):
    """``x`` as a torch tensor for an entry point.

    A tensor keeps its device (and dtype): a CPU tensor is how a caller, and
    the tests, ask for the CPU.  Anything else (a numpy array, a list) goes
    to the card, converted to ``dtype`` where one is given; with no card
    that raises, and nothing falls back to the CPU.
    """
    if isinstance(x, torch.Tensor):
        return x
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a numpy or list input runs on the card; pass a "
            "CPU torch.Tensor to run on the CPU")
    return torch.as_tensor(np.asarray(x), dtype=dtype,
                           device=torch.device("cuda"))
