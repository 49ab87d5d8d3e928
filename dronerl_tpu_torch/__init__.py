"""PyTorch/CUDA port of dronerl_tpu.

The package mirrors the JAX package's module names (``env.core``,
``agents.dqn``, ``ops.fused_tick``, ``train``) so each module's
counterpart is easy to find. It imports ``torch`` and numpy only: never
``jax`` and never ``dronerl_tpu``.

Entry points take an explicit ``device``. They default to ``cuda`` and
raise when no card is present, unless the caller passes ``device="cpu"``.
On CPU tensors every kernel wrapper runs its plain PyTorch version; on
CUDA tensors it launches the hand-written kernel or raises.
"""

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises instead of falling back."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (CLI: --device cpu) "
            "to run the plain PyTorch path on the CPU")
    return device
