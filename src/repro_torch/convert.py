"""Carry state from the JAX package to the port and results back.

What crosses between the two packages is a PRNG key, a (B, V) table, a
lattice model's or a density's parameters, a grid codec, the chain's
init words, an engine config, and a language model's weights.
The JAX side hands them over as numpy arrays (``np.asarray`` of a jax
array) and a plain dict; these functions turn them into the port's
tensors on a device (the current CUDA card unless ``device="cpu"`` is
passed; without a card they raise), and an ``EngineResult`` back into numpy with the
JAX package's dtypes, so the two can be compared array for array.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.targets import GaussianMixture, GridCodec, MultivariateGaussian
from repro_torch.models.lm import LM, STACKS
from repro_torch.samplers.engine import (
    EngineConfig,
    EngineResult,
    resolve_device,
)
from repro_torch.samplers.targets import TableTarget
from repro_torch.workloads.ising import IsingModel


def key_from_numpy(key, device=None) -> torch.Tensor:
    """A raw ``uint32[2]`` PRNG key -> the port's int64 (2,) key."""
    key = np.asarray(key)
    if key.shape != (2,):
        raise ValueError(f"a raw PRNG key has shape (2,), got {key.shape}")
    return torch.from_numpy(key.astype(np.int64)).to(resolve_device(device))


def table_from_numpy(table, device=None) -> torch.Tensor:
    """A (B, V) log-prob table -> float32 tensor."""
    table = np.asarray(table, dtype=np.float32)
    if table.ndim != 2:
        raise ValueError(f"a table is (B, V), got {table.shape}")
    return torch.from_numpy(table.copy()).to(resolve_device(device))


def words_from_numpy(words, device=None) -> torch.Tensor:
    """uint32 init words -> int64 tensor: an MH chain state (B, C) or
    (num_chains, B, C), or a lattice state (B, H, W) or (num_chains, B,
    H, W)."""
    words = np.asarray(words)
    if words.ndim not in (2, 3, 4):
        raise ValueError(
            f"init words are (B, C), (num_chains, B, C), (B, H, W) or "
            f"(num_chains, B, H, W), got {words.shape}"
        )
    words = torch.from_numpy(words.astype(np.uint32).astype(np.int64))
    return words.to(resolve_device(device))


def couplings_from_numpy(j_right, j_down, device=None) -> tuple:
    """A spin glass's (H, W) couplings -> two float32 tensors, the
    arguments of ``workloads.spin_glass.SpinGlass``."""
    out = []
    for j in (j_right, j_down):
        j = np.asarray(j, dtype=np.float32)
        if j.ndim != 2:
            raise ValueError(f"couplings are (H, W), got {j.shape}")
        out.append(torch.from_numpy(j.copy()).to(resolve_device(device)))
    return tuple(out)


def ising_from_jax(model) -> IsingModel:
    """The port's ``IsingModel`` with a JAX ``IsingModel``'s (height,
    width, beta, field); read by attribute, so nothing of JAX is imported."""
    return IsingModel(
        height=int(model.height), width=int(model.width),
        beta=float(model.beta), field=float(model.field),
    )


def _floats(x) -> tuple:
    """A nested sequence of numbers as nested tuples of Python floats."""
    if np.ndim(x) == 0:
        return float(x)
    return tuple(_floats(v) for v in x)


def codec_from_jax(codec) -> GridCodec:
    """The port's ``GridCodec`` with a JAX ``GridCodec``'s fields."""
    return GridCodec(
        nbits=int(codec.nbits), dim=int(codec.dim), lo=_floats(codec.lo),
        hi=_floats(codec.hi), gray=bool(codec.gray),
    )


def gaussian_mixture_from_jax(gmm) -> GaussianMixture:
    """The port's ``GaussianMixture`` with a JAX mixture's parameters."""
    return GaussianMixture(_floats(gmm.means), _floats(gmm.covs), _floats(gmm.weights))


def multivariate_gaussian_from_jax(mgd) -> MultivariateGaussian:
    """The port's ``MultivariateGaussian`` with a JAX one's parameters."""
    return MultivariateGaussian(mean=_floats(mgd.mean), cov=_floats(mgd.cov))


def table_target_from_numpy(table, nbits: int | None = None, device=None) -> TableTarget:
    """A (B, V) log-prob table built by the JAX package (for example the
    ``gmm`` workload's, ``np.asarray(target.table)``) as the port's
    ``TableTarget``: the two engines then sample one table, bit for bit."""
    return TableTarget(table_from_numpy(table, device=device), nbits=nbits)


def config_from_dict(config: dict) -> EngineConfig:
    """An ``EngineConfig`` from the JAX config's fields as a dict."""
    return EngineConfig(**config)


def result_to_numpy(result: EngineResult) -> dict:
    """An ``EngineResult`` as numpy arrays with the JAX package's dtypes
    (uint32 words, int32 counts, float32 log-probs and rate)."""
    return {
        "samples": result.samples.cpu().numpy().astype(np.uint32),
        "accept_count": result.accept_count.cpu().numpy().astype(np.int32),
        "acceptance_rate": np.float32(result.acceptance_rate.cpu().item()),
        "final_words": result.final_words.cpu().numpy().astype(np.uint32),
        "final_logp": result.final_logp.cpu().numpy().astype(np.float32),
        "n_steps": np.int32(result.n_steps),
    }


def _leaf_tensor(value) -> torch.Tensor:
    """A numpy leaf as a CPU tensor; a bfloat16 leaf (numpy's extension
    dtype, which ``torch.from_numpy`` refuses) crosses by its bits."""
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":
        return torch.from_numpy(value.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(value.copy())


def jax_path(name: str) -> tuple[tuple, int | None]:
    """A parameter name's JAX tree path and its index on the stacked layer
    axis (None for an unstacked leaf): block leaves sit under "layers"
    (and the audio family's "encoder") with a leading (L,) axis."""
    parts = name.split(".")
    if parts[0] in STACKS:
        return (parts[0], *parts[2:]), int(parts[1])
    return tuple(parts), None


def _lm_leaves(model: LM):
    """(JAX tree path, layer or None, parameter) for every leaf."""
    for name, p in model.named_parameters():
        yield (*jax_path(name), p)


def named_to_tree(named: dict, stack=np.stack) -> dict:
    """Values keyed by parameter name (``{"layers.0.attn.wq": x, ...}``)
    as the JAX package's value tree: nested dicts, the stacked leaves
    joined on a leading (L,) axis by ``stack`` (``np.stack`` for numpy
    arrays, ``torch.stack`` for tensors)."""
    tree: dict = {}
    stacks: dict = {}
    for name, value in named.items():
        path, layer = jax_path(name)
        if layer is None:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = value
        else:
            stacks.setdefault(path, []).append((layer, value))
    for path, values in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = stack([v for _, v in sorted(values, key=lambda lv: lv[0])])
    return tree


def tree_to_named(tree: dict, names) -> dict:
    """The inverse of ``named_to_tree``: each name's value (a stacked
    leaf's row), read from the JAX layout."""
    out = {}
    for name in names:
        path, layer = jax_path(name)
        node = tree
        for key in path:
            node = node[key]
        out[name] = node if layer is None else node[layer]
    return out


def lm_from_numpy(values, cfg, device=None) -> LM:
    """The port's ``LM`` holding the JAX package's weights: ``values`` is
    ``init_lm_values(key, cfg)[0]`` as numpy arrays (nested dicts; the
    ``layers`` and ``encoder`` leaves stacked on a leading (L,) axis).
    Every leaf of the tree must be used and of the module's shape; each
    is cast to its
    module leaf's dtype: the parameter dtype, or float32 for the MoE
    router, the SSM's ``A_log``, ``D`` and ``dt_bias`` and the hybrid's
    ``branch_scale``, as in the JAX tree."""
    model = LM(cfg, device=resolve_device(device))
    used = set()
    for path, layer, p in _lm_leaves(model):
        node = values
        for key in path:
            if not isinstance(node, dict) or key not in node:
                raise ValueError(f"the weight tree has no leaf {'/'.join(path)}")
            node = node[key]
        leaf = _leaf_tensor(node if layer is None else np.asarray(node)[layer])
        if tuple(leaf.shape) != tuple(p.shape):
            raise ValueError(f"{'/'.join(path)}: shape {tuple(leaf.shape)}, the model's "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(leaf.to(p.dtype))
        used.add(path)

    def paths(node, prefix=()):
        if isinstance(node, dict):
            for key, sub in node.items():
                yield from paths(sub, prefix + (key,))
        else:
            yield prefix

    extra = set(paths(values)) - used
    if extra:
        raise ValueError(f"the model has no parameter for {sorted(extra)}")
    return model


def lm_to_numpy(model: LM) -> dict:
    """The model's weights as the JAX package's value tree of numpy arrays
    (``layers`` and ``encoder`` leaves stacked on a leading (L,) axis); a
    bfloat16 leaf is widened to float32, which ``lm_from_numpy`` narrows
    back exactly."""
    return named_to_tree({
        name: p.detach().float().cpu().numpy() if p.dtype == torch.bfloat16 else (
            p.detach().cpu().numpy())
        for name, p in model.named_parameters()
    })
