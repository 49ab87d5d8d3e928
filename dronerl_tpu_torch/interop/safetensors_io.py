"""Dual-format (jax / torch) safetensors weight checkpoints (counterpart of
``dronerl_tpu/interop/safetensors_io.py``), with the port's own reader and
writer of the safetensors format.

The on-disk contract is the JAX package's, so checkpoints cross between
the two packages in both directions:

* tensors: the flattened flax parameter tree with ``.``-joined keys;
* string metadata: ``network_type``, ``dense_layers``, ``conv_layers``,
  ``conv_dense_layers``, ``obs_shape``, ``action_shape``,
  ``checkpoint_format`` ∈ {``jax``, ``torch``} and
  ``checkpoint_format_version``;
* the torch format renames ``params.Dense_k.kernel`` →
  ``network.dense_{k+1}.weight`` (transposed) and ``params.Conv_k.kernel``
  → ``network.conv2d_{k+1}.weight`` (HWIO → OIHW).

Loading a jax checkpoint through the torch path (or the reverse) raises:
the format field is a hard guard.

The format itself: an 8-byte little-endian header length, a JSON header
``{name: {"dtype", "shape", "data_offsets"}, "__metadata__": {str: str}}``
padded with spaces to 8 bytes, then each tensor's raw little-endian bytes,
back to back in the header's order. :func:`write` and :func:`read` handle
it with the standard library and ``torch`` alone (bfloat16 included), so
the port needs no ``safetensors`` package. The loaders return flax-layout
numpy trees, which ``interop.from_jax.qnet_from_flax`` turns into the
port's nets.
"""

import ast
import json
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from dronerl_tpu_torch.constants import NUM_ACTIONS

FORMAT_VERSION = "0.1"

_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


class CheckpointFormatError(Exception):
    """Raised when a checkpoint's format does not match the loader."""


# --- the file format ----------------------------------------------------------

def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    return torch.from_numpy(np.ascontiguousarray(np.asarray(value)))


def write(path: str, tensors: Dict[str, Any],
          metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``tensors`` (name → torch tensor or numpy array) and the string
    ``metadata`` as one safetensors file, the tensors in name order."""
    header, chunks, offset = {}, [], 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in
                                  metadata.items()}
    for name in sorted(tensors):
        t = _as_tensor(tensors[name]).contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} has no safetensors "
                            "name")
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        chunks.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in chunks:
            f.write(raw)


def _header(f, path: str) -> Tuple[dict, int]:
    head = f.read(8)
    if len(head) != 8:
        raise CheckpointFormatError(f"{path} is not a safetensors file")
    (size,) = struct.unpack("<Q", head)
    blob = f.read(size)
    if len(blob) != size or not blob.lstrip().startswith(b"{"):
        raise CheckpointFormatError(f"{path}: malformed safetensors header")
    return json.loads(blob), 8 + size


def read(path: str) -> Tuple[Dict[str, torch.Tensor], Dict[str, str]]:
    """Read a safetensors file → (name → CPU tensor, string metadata)."""
    with open(path, "rb") as f:
        header, start = _header(f, path)
        data = f.read()
    metadata = header.pop("__metadata__", None) or {}
    tensors = {}
    for name, info in header.items():
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise CheckpointFormatError(
                f"{path}: {name} has dtype {info['dtype']}, which the port "
                "does not read")
        lo, hi = info["data_offsets"]
        shape = tuple(info["shape"])
        if hi > len(data) or hi - lo != (
                int(np.prod(shape)) * torch.empty((), dtype=dtype)
                .element_size()):
            raise CheckpointFormatError(f"{path}: {name}'s bytes do not "
                                        "match its shape and dtype")
        if hi == lo:
            tensors[name] = torch.empty(shape, dtype=dtype)
        else:
            raw = torch.frombuffer(bytearray(data[lo:hi]), dtype=torch.uint8)
            tensors[name] = raw.view(dtype).reshape(shape)
    return tensors, dict(metadata)


def read_metadata(path: str) -> dict:
    with open(path, "rb") as f:
        header, _ = _header(f, path)
    return dict(header.get("__metadata__") or {})


def load_file(path: str) -> Dict[str, np.ndarray]:
    """name → numpy array (``safetensors.numpy.load_file``)."""
    return {k: v.numpy() for k, v in read(path)[0].items()}


# --- trees ---------------------------------------------------------------------

def flatten_dict(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(flatten_dict(value, name + "."))
        else:
            out[name] = value
    return out


def unflatten_dict(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _flax_params(params) -> Dict[str, Any]:
    """A port net (``QNet``) or a flax-layout tree → the flax tree."""
    if isinstance(params, torch.nn.Module):
        from dronerl_tpu_torch.interop.from_jax import qnet_to_flax

        return qnet_to_flax(params)
    return params


def _to_host(params) -> Dict[str, np.ndarray]:
    return {k: np.ascontiguousarray(np.asarray(
        v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v))
        for k, v in flatten_dict(_flax_params(params)).items()}


def _metadata(config, env_params, fmt: str) -> dict:
    if fmt == "torch" and config.network_type == "conv":
        # The reference's torch loader reads the conv head widths from
        # dense_layers.
        dense_layers = str(tuple(config.conv_dense_layers))
    else:
        dense_layers = str(tuple(config.hidden_layers))
    return {
        "network_type": config.network_type,
        "dense_layers": dense_layers,
        "conv_layers": str(config.conv_specs()),
        "conv_dense_layers": str(tuple(config.conv_dense_layers)),
        # (2r+1, 2r+1, C) for 'window', (grid, grid, C) for 'global'.
        "obs_shape": str(tuple(env_params.obs_shape)),
        "action_shape": str((NUM_ACTIONS,)),
        "checkpoint_format": fmt,
        "checkpoint_format_version": FORMAT_VERSION,
    }


def save_jax(path: str, params, config, env_params) -> None:
    """Write q-network params (a port net or a flax tree) in the JAX
    package's naming scheme."""
    write(path, _to_host(params), _metadata(config, env_params, "jax"))


def save_torch(path: str, params, config, env_params) -> None:
    """Write q-network params renamed and transposed for the torch
    loader."""
    renamed = {}
    for key, tensor in _to_host(params).items():
        parts = key.split(".")
        if parts[0] == "params":
            parts[0] = "network"
        layer = parts[1]
        if layer.startswith("Dense"):
            parts[1] = f"dense_{int(layer.split('_')[1]) + 1}"
        elif layer.startswith("Conv"):
            parts[1] = f"conv2d_{int(layer.split('_')[1]) + 1}"
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            if parts[1].startswith("dense"):
                tensor = tensor.T
            elif parts[1].startswith("conv"):
                tensor = tensor.transpose(3, 2, 0, 1)  # HWIO → OIHW
            else:
                raise CheckpointFormatError(f"Unexpected parameter key {key!r}")
        renamed[".".join(parts)] = np.ascontiguousarray(tensor)
    write(path, renamed, _metadata(config, env_params, "torch"))


def _config_from_metadata(metadata: dict):
    from dronerl_tpu_torch.agents.dqn import DQNConfig

    network_type = metadata.get("network_type", "dense")
    if network_type == "dense":
        return DQNConfig(
            network_type="dense",
            hidden_layers=tuple(ast.literal_eval(metadata["dense_layers"])))
    if network_type == "conv":
        # The reference's torch checkpoints carry the conv head widths in
        # dense_layers and have no conv_dense_layers: prefer the explicit
        # key, fall back to the historical one.
        head = metadata.get("conv_dense_layers", metadata.get("dense_layers"))
        if head is None:
            raise CheckpointFormatError(
                "conv checkpoint metadata has neither 'conv_dense_layers' "
                "nor 'dense_layers' — malformed checkpoint (refusing to "
                "default to an empty dense head)")
        return DQNConfig(
            network_type="conv",
            conv_layers=ast.literal_eval(metadata["conv_layers"]),
            conv_dense_layers=tuple(ast.literal_eval(head)))
    raise CheckpointFormatError(f"Unknown network type {network_type!r}")


def load_jax(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Load a jax-format checkpoint → (config, flax params tree of numpy
    arrays)."""
    metadata = read_metadata(path)
    if metadata.get("checkpoint_format") != "jax":
        raise CheckpointFormatError(
            f"{path} is not a jax-format checkpoint "
            f"(format={metadata.get('checkpoint_format')!r})")
    return _config_from_metadata(metadata), unflatten_dict(load_file(path))


def load_torch(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Load a torch-format checkpoint (the reference's NCHW files included)
    → (config, flax params tree of numpy arrays)."""
    metadata = read_metadata(path)
    if metadata.get("checkpoint_format", "torch") != "torch":
        raise CheckpointFormatError(
            f"{path} is not a torch-format checkpoint "
            f"(format={metadata.get('checkpoint_format')!r})")
    renamed = {}
    for key, tensor in load_file(path).items():
        parts = key.split(".")
        if parts[0] == "network":
            parts[0] = "params"
        layer = parts[1]
        if layer.startswith("dense"):
            parts[1] = f"Dense_{int(layer.split('_')[1]) - 1}"
        elif layer.startswith("conv2d"):
            parts[1] = f"Conv_{int(layer.split('_')[1]) - 1}"
        if parts[-1] == "weight":
            parts[-1] = "kernel"
            if parts[1].startswith("Dense"):
                tensor = tensor.T
            elif parts[1].startswith("Conv"):
                tensor = tensor.transpose(2, 3, 1, 0)  # OIHW → HWIO
            else:
                raise CheckpointFormatError(f"Unexpected parameter key {key!r}")
        renamed[".".join(parts)] = np.ascontiguousarray(tensor)
    return _config_from_metadata(metadata), unflatten_dict(renamed)


def load_checkpoint(path: str) -> Tuple[Any, Dict[str, Any]]:
    """Format-dispatching loader: jax- or torch-format checkpoints."""
    fmt = read_metadata(path).get("checkpoint_format", "torch")
    if fmt == "jax":
        return load_jax(path)
    if fmt == "torch":
        return load_torch(path)
    raise CheckpointFormatError(f"Unknown checkpoint format {fmt!r}")
