"""Full-training-state checkpoints (resume; counterpart of
``dronerl_tpu/interop/train_state_io.py``).

Persists a trainer's whole carry: the host key, the env state (batched
``EnvState`` or the feature-major ``TState``), the current observations
or the replay ring and its scalar rings, the learner state (online and
target nets, Adam moments and count, ε), the replay's storage, cursor and
size, the ``in_kernel_td`` batch and the step counter, so that a run
resumes where it stopped and ``train(2N)`` equals ``train(N)`` + resume +
``train(N)`` bit for bit.

The file is the port's own: a safetensors file (``interop.
safetensors_io.write``) whose tensors are the carry's tensors keyed by
their path in the carry (``3.opt_state.mu.0``), whose metadata holds the
Python numbers (step, cursor, size, the Adam count) as JSON. It is not
the JAX package's flax-msgpack file: train states do not cross between
the two frameworks (weights checkpoints do).

:func:`restore` takes a template carry built from the same arguments: the
file must hold exactly the template's paths, each tensor of the
template's shape and dtype (flax's ``from_bytes`` checks the same). Each
tensor lands on its template tensor's device, contiguous.
"""

import dataclasses
import json
from typing import Any, Dict

import torch

from dronerl_tpu_torch.interop import safetensors_io

FORMAT = "dronerl_tpu_torch.train_state"
VERSION = "1"


def _children(node):
    """(key, child) pairs of a carry node, or None for a leaf."""
    if isinstance(node, torch.nn.Module):
        return list(enumerate(node.flat()))
    if isinstance(node, dict):
        return list(node.items())
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    return None


def _flatten(node, prefix: str, tensors: Dict[str, torch.Tensor],
             numbers: Dict[str, Any]) -> None:
    children = _children(node)
    if children is not None:
        for key, child in children:
            _flatten(child, f"{prefix}{key}.", tensors, numbers)
        return
    path = prefix[:-1]
    if isinstance(node, torch.Tensor):
        tensors[path] = node
    elif node is None or isinstance(node, (bool, int, float)):
        numbers[path] = node
    else:
        raise TypeError(f"carry leaf {path!r} of type {type(node).__name__} "
                        "cannot be saved")


def save(path: str, carry: Any) -> None:
    """Write ``carry`` (any trainer's) to ``path``."""
    tensors, numbers = {}, {}
    _flatten(carry, "", tensors, numbers)
    safetensors_io.write(path, tensors, {
        "format": FORMAT, "version": VERSION,
        "numbers": json.dumps(numbers, sort_keys=True)})


def _rebuild(node, prefix: str, tensors, numbers):
    children = _children(node)
    if children is None:
        path = prefix[:-1]
        if isinstance(node, torch.Tensor):
            t = tensors[path]
            if tuple(t.shape) != tuple(node.shape) or t.dtype != node.dtype:
                raise ValueError(
                    f"train state {path!r}: {t.dtype} {tuple(t.shape)} in "
                    f"the file, {node.dtype} {tuple(node.shape)} in the "
                    "template")
            return t.to(node.device).contiguous()
        value = numbers[path]
        if type(value) is not type(node):
            raise ValueError(f"train state {path!r}: {value!r} in the file, "
                             f"a {type(node).__name__} in the template")
        return value
    values = {key: _rebuild(child, f"{prefix}{key}.", tensors, numbers)
              for key, child in children}
    if isinstance(node, torch.nn.Module):
        with torch.no_grad():
            for key, p in enumerate(node.flat()):
                p.copy_(values[key])
        return node
    if isinstance(node, dict):
        return values
    if isinstance(node, list):
        return [values[i] for i in range(len(node))]
    if isinstance(node, tuple):
        items = [values[i] for i in range(len(node))]
        return type(node)(*items) if hasattr(node, "_fields") else tuple(
            items)
    return dataclasses.replace(node, **values)


def restore(path: str, template: Any) -> Any:
    """The carry saved in ``path``, in ``template``'s structure (a carry
    built from the same arguments; its nets are overwritten in place)."""
    tensors, metadata = safetensors_io.read(path)
    if metadata.get("format") != FORMAT:
        raise safetensors_io.CheckpointFormatError(
            f"{path} is not a train state of the PyTorch port (format="
            f"{metadata.get('format')!r}); the JAX package's msgpack train "
            "states do not load here")
    numbers = json.loads(metadata["numbers"])
    want_t, want_n = {}, {}
    _flatten(template, "", want_t, want_n)
    if set(want_t) != set(tensors) or set(want_n) != set(numbers):
        missing = sorted((set(want_t) | set(want_n))
                         - (set(tensors) | set(numbers)))
        extra = sorted((set(tensors) | set(numbers))
                       - (set(want_t) | set(want_n)))
        raise ValueError(f"train state {path} does not match the template: "
                         f"missing {missing[:8]}, unexpected {extra[:8]}")
    return _rebuild(template, "", tensors, numbers)
