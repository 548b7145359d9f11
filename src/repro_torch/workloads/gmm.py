"""Gaussian-mixture posterior workload — MC²RAM's in-SRAM benchmark — the
PyTorch port of ``repro.workloads.gmm``.

Draw posterior samples from the paper's Fig. 17(a) 4-component mixture by
MH over a ``GridCodec`` lattice of 2^nbits cells.  The canonical target is
a ``CallableTarget`` over the discretized space (``make_callable_target``);
``build`` materialises it into a ``TableTarget`` (one density evaluation
per grid cell, done once) so the same workload runs under both executors,
the MH kernels included.

The table is evaluated on the CPU, where its float32 arithmetic is held
against the JAX package, and then moved to the engine's device, so every
device samples the same table.  That evaluation holds a few (2^nbits, 4)
float32 temporaries in host memory, 256 MiB each at nbits 24: keep the
table form at nbits <= 24 and use ``make_callable_target`` (scan) beyond.
"""

from __future__ import annotations

import torch

from repro_torch import prng, samplers
from repro_torch.core.targets import GaussianMixture, GridCodec, reference_grid_probs
from repro_torch.samplers.engine import resolve_device
from repro_torch.workloads.ising import _key


def default_model() -> tuple[GaussianMixture, GridCodec]:
    """The paper's Fig. 17(a) mixture on the Fig. 17 grid box."""
    return (
        GaussianMixture.paper_gmm(),
        GridCodec(nbits=8, dim=1, lo=(-10.0,), hi=(10.0,)),
    )


def make_callable_target(gmm: GaussianMixture, codec: GridCodec) -> samplers.CallableTarget:
    """The workload's defining form: log p over words = log density at the
    decoded grid point (scan execution, any nbits)."""

    def log_prob(words: torch.Tensor) -> torch.Tensor:
        # decode gives (..., dim); the mixture's log_prob consumes dim
        return gmm.log_prob(codec.decode(words))

    return samplers.CallableTarget(log_prob, codec.nbits)


def make_table_target(gmm: GaussianMixture, codec: GridCodec, device=None) -> samplers.TableTarget:
    """The callable target materialised cell by cell into a (1, 2^nbits)
    table on ``device`` (the card unless ``"cpu"``) — the kernel-eligible
    form of the same distribution."""
    words = torch.arange(1 << codec.nbits, dtype=torch.int64)
    table = gmm.log_prob(codec.decode(words))[None, :]
    return samplers.TableTarget(table.to(resolve_device(device)), nbits=codec.nbits)


def build(
    key,
    randomness: str = "cim",
    backend: str = "auto",
    smoke: bool = False,
    nbits: int | None = None,
    chains: int | None = None,
    n_steps: int | None = None,
    chunk_steps: int = 32,
    num_chains: int = 1,
    collect: str = "all",
    device=None,
):
    """Assemble the GMM posterior workload (see ``workloads.WorkloadRun``).

    The JAX builder's arguments and defaults, plus ``device``.  ``chains``
    is the macro's lock-step compartment axis (one table, C columns);
    ``num_chains`` is the engine's independent-chains axis, with
    counter-derived per-chain inits.
    """
    from repro_torch import workloads  # workloads imports this module

    device = resolve_device(device)
    nbits = nbits or 8
    chains = chains or (16 if smoke else 64)
    n_steps = n_steps or (96 if smoke else 2048)
    gmm = GaussianMixture.paper_gmm()
    codec = GridCodec(nbits=nbits, dim=1, lo=(-10.0,), hi=(10.0,))
    target = make_table_target(gmm, codec, device=device)
    engine = samplers.MHEngine(
        samplers.EngineConfig(
            update="mh", randomness=randomness, execution=backend,
            chunk_steps=chunk_steps, num_chains=num_chains, collect=collect,
        ),
        device=device,
    )
    keys = samplers.chain_keys(_key(key, device), num_chains)
    init = prng.randint(keys, (1, chains), 0, 1 << nbits)
    if num_chains == 1:
        init = init[0]

    def series_fn(samples: torch.Tensor) -> torch.Tensor:
        # (K, 1, C) words -> (K, C) decoded x coordinates
        x = codec.decode(samples)[..., 0]
        return x.reshape(x.shape[0], -1)

    return workloads.WorkloadRun(
        name="gmm",
        engine=engine,
        target=target,
        init_words=init,
        n_steps=n_steps,
        burn_in=n_steps // 4,
        series_fn=series_fn,
        meta={
            "nbits": nbits,
            "chains": chains,
            "num_chains": num_chains,
            "components": len(gmm.weights),
            "statistic": "x",
        },
    )


def reference_probs(nbits: int = 8):
    """Exact normalised cell probabilities (for TV-distance checks)."""
    gmm = GaussianMixture.paper_gmm()
    codec = GridCodec(nbits=nbits, dim=1, lo=(-10.0,), hi=(10.0,))
    return reference_grid_probs(gmm, codec)
