"""The port's token sampler and LLM server against the JAX package's
(``tests/test_serving.py:TestBatchedServerSmoke``, ``tests/test_system.py``).

The sampler is held exactly on JAX's logits: tokens, acceptance and
``final_logp``.  The servers serve the same prompts with the JAX server's
weights carried across (``convert.lm_from_numpy``); their token streams
must be equal, under the rule that decides when two implementations may
part (ROADMAP.md queue 3 item 2): a sample is held only where the two
logit rows' difference cannot change it.  For ``greedy`` that is a top-two
gap of the logits above the measured difference, for ``categorical`` the
same of ``logits + gumbel``, and for ``mcmc`` a chain with no tie event
(``kernels/mh/ref.py:tie_events``) whose every accept margin exceeds the
logit difference.  The seeds below pass that rule; a seed that failed it
would be reported by the assertion and replaced, never absorbed.
"""

import dataclasses
import io
import re
import sys
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import token_sampler as jts
from repro.launch import serve as jserve
from repro_torch import configs, convert, prng, samplers
from repro_torch.core import token_sampler as ts
from repro_torch.kernels.mh import ref as mref
from repro_torch.launch import serve
from repro_torch.samplers import chain_key

partitionable = pytest.mark.skipif(
    not jax.config.jax_threefry_partitionable,
    reason="repro_torch.prng reproduces the partitionable Threefry layout only",
)
pytestmark = partitionable


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mcmc_margin(key, logits, cfg: ts.TokenSamplerConfig) -> tuple[int, float]:
    """(tie events, least accept margin) of the chain ``_sample_tokens_impl``
    runs on ``logits`` (B, V) in one chunk: a logit difference below half
    the margin changes no accept decision (``mref.accept_margin``)."""
    eng = samplers.MHEngine(cfg.engine_config(), device="cpu")
    table = logits / torch.full_like(logits, cfg.temperature)
    init = torch.argmax(table, dim=-1)[:, None]
    flips, u = eng.randomness.chunk(chain_key(eng._key(key), 0), 0, cfg.n_steps,
                                    tuple(init.shape), cfg.nbits)
    return (len(mref.tie_events(table, init, flips, u, cfg.nbits)),
            mref.accept_margin(table, init, flips, u, cfg.nbits))


# --- the token sampler -------------------------------------------------------------


@pytest.mark.parametrize("b,execution", [(4, "scan"), (1, "scan"), (4, "pallas")])
def test_sample_tokens_equal_jax_on_jax_logits(b, execution):
    """B = 4 (a decode step) and 1 (an admission), 32 steps: the server's
    shapes at the smoke vocabulary (259: nbits 9)."""
    jcfg = jconfigs.get_smoke_config("granite3_8b")
    cfg = dict(vocab_size=jcfg.vocab_size, n_steps=32, execution=execution)
    logits = np.array(jax.random.normal(jax.random.PRNGKey(b), (b, jcfg.vocab_size)) * 3)
    key = jax.random.PRNGKey(11 + b)
    ref = jts._sample_tokens_impl(key, jnp.asarray(logits), jts.TokenSamplerConfig(**cfg))
    tcfg = ts.TokenSamplerConfig(**cfg)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    out = ts._sample_tokens_impl(tkey, torch.from_numpy(logits), tcfg)
    assert _mcmc_margin(tkey, torch.from_numpy(logits), tcfg)[0] == 0
    np.testing.assert_array_equal(np.asarray(ref.tokens), out.tokens.numpy())
    assert out.tokens.dtype == torch.int32
    # the denominators (32 x 4, 32 x 1) are powers of two, so the jitted
    # JAX division (a reciprocal multiply) is exact too
    assert np.float32(ref.acceptance_rate) == out.acceptance_rate.item()
    np.testing.assert_array_equal(np.asarray(ref.final_logp), out.final_logp.numpy())
    with pytest.warns(DeprecationWarning, match="deprecated"):
        again = ts.sample_tokens(tkey, torch.from_numpy(logits), tcfg)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        jagain = jts.sample_tokens(key, jnp.asarray(logits), jts.TokenSamplerConfig(**cfg))
    np.testing.assert_array_equal(np.asarray(jagain.tokens), again.tokens.numpy())


def test_token_sampler_config_and_device_rule():
    for kw in (dict(vocab_size=259), dict(vocab_size=49155, top_k=40, randomness="host")):
        j, t = jts.TokenSamplerConfig(**kw), ts.TokenSamplerConfig(**kw)
        assert t.nbits == j.nbits
        assert dataclasses.asdict(t.engine_config()) == {
            k: v for k, v in dataclasses.asdict(j.engine_config()).items()
            if k in {f.name for f in dataclasses.fields(t.engine_config())}}
    if not torch.cuda.is_available():  # numpy logits go to the card, and there is none
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ts._sample_tokens_impl(prng.PRNGKey(0), np.zeros((1, 8), np.float32),
                                   ts.TokenSamplerConfig(vocab_size=8))


# --- prng: uniform on a range, gumbel, categorical ----------------------------------


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0),
                                   (-2.5, 3.0), (1e-3, 1e-3 + 1e-6)])
def test_uniform_range_exact(lo, hi):
    key = jax.random.PRNGKey(5)
    ref = jax.random.uniform(key, (7, 301), minval=lo, maxval=hi)
    out = prng.uniform(torch.from_numpy(np.asarray(key).astype(np.int64)), (7, 301), lo, hi)
    np.testing.assert_array_equal(np.asarray(ref), out.numpy())
    assert out.min() >= np.float32(lo)


def test_gumbel_and_categorical():
    key = jax.random.PRNGKey(9)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    ref = np.asarray(jax.random.gumbel(key, (5, 259)))
    out = prng.gumbel(tkey, (5, 259)).numpy()
    # measured: 9.5e-7 (values up to 7.4): the two logs may differ in the last bit
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-6)
    logits = np.array(jax.random.normal(jax.random.PRNGKey(2), (5, 259)) * 3)
    noisy = np.sort(ref + logits, axis=-1)
    assert (noisy[:, -1] - noisy[:, -2]).min() > 4e-6  # no near tie at the argmax
    np.testing.assert_array_equal(np.asarray(jax.random.categorical(key, logits, axis=-1)),
                                  prng.categorical(tkey, torch.from_numpy(logits)).numpy())


# --- the server --------------------------------------------------------------------


class Recorded:
    """Wraps a server's ``_sample`` to keep each call's logits and key."""

    def __init__(self, server):
        self.calls = []
        real = server._sample

        def sample(logits):
            self.calls.append((np.asarray(logits, np.float32) if not isinstance(
                logits, torch.Tensor) else logits.numpy().copy(), np.asarray(server.key)))
            return real(logits)

        server._sample = sample


def _drive(server, requests):
    """``main``'s loop: admit into the lowest free slot, FIFO, then step."""
    queue, finished = list(requests), []
    while queue or server.active():
        while queue and server.free_slot() is not None:
            server.submit(server.free_slot(), queue.pop(0))
        finished.extend(server.step())
    return {r.rid: list(r.out_tokens) for r in finished}


def _servers(sampler, n_slots, max_len, gen, seed=0, mcmc_steps=8, arch="granite3_8b"):
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = configs.get_smoke_config(arch)
    kw = dict(n_slots=n_slots, max_len=max_len, gen_tokens=gen, sampler=sampler,
              mcmc_steps=mcmc_steps, seed=seed)
    js = jserve.BatchedServer(jcfg, jserve.ServeConfig(**kw))
    ps = serve.BatchedServer(tcfg, serve.ServeConfig(**kw), device="cpu")
    ps.model = convert.lm_from_numpy(jax.tree.map(np.asarray, js.vals), tcfg, device="cpu")
    return jcfg, js, ps


def _gap(rows) -> float:
    top = np.sort(rows, axis=-1)
    return float((top[:, -1] - top[:, -2]).min())


def _streams_equal_jax(arch, sampler, logit_tol, prompt_seed=3):
    """5 requests on 4 slots with ``main``'s cache sizing (prompt 4 + 2 +
    gen 12 + 8 = 26): the three slots left idle while request 4 decodes
    write past the cache and are clamped to its last row.  The largest
    logit difference over the calls must be under ``logit_tol``."""
    prompt_len, gen = 4, 12
    jcfg, js, ps = _servers(sampler, 4, prompt_len + 2 + gen + 8, gen, arch=arch)
    rec_j, rec_p = Recorded(js), Recorded(ps)
    rng = np.random.default_rng(prompt_seed)
    prompts = [rng.integers(0, jcfg.vocab_size, size=prompt_len + rid % 3) for rid in range(5)]
    ref = _drive(js, [jserve.Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    out = _drive(ps, [serve.Request(rid=i, prompt=p) for i, p in enumerate(prompts)])
    assert int(np.asarray(js.cache["index"]).max()) > js.scfg.max_len  # the clamp ran
    np.testing.assert_array_equal(np.asarray(js.cache["index"]), ps.cache["index"].numpy())
    assert len(rec_j.calls) == len(rec_p.calls) == 5 + 2 * gen
    v = jcfg.vocab_size
    diff = max(float(np.abs(a[0][:, :v] - b[0][:, :v]).max())
               for a, b in zip(rec_j.calls, rec_p.calls))
    assert diff < logit_tol, diff
    for (jl, jkey), (pl, pkey) in zip(rec_j.calls, rec_p.calls):
        np.testing.assert_array_equal(jkey.astype(np.int64), pkey)  # one split a sample
        if sampler == "greedy":
            assert _gap(pl[:, :v]) > diff, "a near tie: replace the seed"
        elif sampler == "categorical":
            sub = np.asarray(jax.random.split(jnp.asarray(jkey.astype(np.uint32)))[1])
            noisy = pl[:, :v] + np.asarray(jax.random.gumbel(sub, pl[:, :v].shape))
            assert _gap(noisy) > diff + 4e-6, "a near tie: replace the seed"
        else:
            sub = prng.split(torch.from_numpy(pkey))[1]
            ties, margin = _mcmc_margin(sub, torch.from_numpy(pl[:, :v]), ps.sampler_cfg)
            assert ties == 0 and margin > 2 * diff and _gap(pl[:, :v]) > diff, (
                "a near tie: replace the seed")
    assert out == ref
    assert all(len(t) == 1 + gen for t in out.values())
    if sampler == "mcmc":
        np.testing.assert_array_equal(np.float32(js.acceptance), np.float32(ps.acceptance))
    else:
        assert not ps.acceptance


@pytest.mark.parametrize("sampler", ["greedy", "categorical", "mcmc"])
def test_server_streams_equal_jax(sampler):
    # measured: 1.2e-4 (greedy), 5.9e-5 (categorical), 7.7e-5 (mcmc) at
    # most over the 29 calls, for logits up to 4.6
    _streams_equal_jax("granite3_8b", sampler, 2e-4)


# measured over the 29 calls (logits up to 4.3), greedy and mcmc:
# qwen3-moe 1.5e-6 and 1.9e-6, mamba2 6.6e-6 and 3.8e-6, hymba 3.7e-5 and
# 6.1e-5 (its attention branch, as in tests/test_torch_ssm.py)
FAMILY_LOGIT_TOL = {"qwen3_moe_30b": 5e-6, "mamba2_1p3b": 1e-5, "hymba_1p5b": 1e-4}


@pytest.mark.parametrize("sampler", ["greedy", "mcmc"])
@pytest.mark.parametrize("arch", sorted(FAMILY_LOGIT_TOL))
def test_family_server_streams_equal_jax(arch, sampler):
    """The MoE, SSM and hybrid smoke servers: the SSM state and the
    hybrid's nested cache are spliced into their slots.  The prompts come
    from seed 4: under seed 3 a hymba ``mcmc`` chain's accept margin (7.4e-5)
    is under twice the logit difference (6.6e-5), a near tie."""
    _streams_equal_jax(arch, sampler, FAMILY_LOGIT_TOL[arch], prompt_seed=4)


class TestBatchedServerSmoke:
    """tests/test_serving.py:TestBatchedServerSmoke on the port."""

    GEN = 3

    def _server(self, n_slots):
        cfg = configs.get_smoke_config("granite3_8b")
        scfg = serve.ServeConfig(n_slots=n_slots, max_len=24, gen_tokens=self.GEN,
                                 sampler="greedy", seed=0)
        return cfg, serve.BatchedServer(cfg, scfg, device="cpu")

    def test_heterogeneous_prompts_decode_like_solo(self):
        cfg, packed = self._server(2)
        rng = np.random.default_rng(0)
        p0 = rng.integers(0, cfg.vocab_size, size=5)
        p1 = rng.integers(0, cfg.vocab_size, size=9)
        out = _drive(packed, [serve.Request(rid=0, prompt=p0), serve.Request(rid=1, prompt=p1)])
        assert all(len(t) == 1 + self.GEN for t in out.values())
        for rid, prompt in ((0, p0), (1, p1)):
            _, solo = self._server(1)
            ref = _drive(solo, [serve.Request(rid=rid, prompt=prompt)])
            assert out[rid] == ref[rid], f"packed decode diverged rid={rid}"

    def test_retired_slot_is_refilled(self):
        cfg, server = self._server(1)
        rng = np.random.default_rng(1)
        first = serve.Request(rid=0, prompt=rng.integers(0, cfg.vocab_size, size=4))
        out = _drive(server, [first])
        assert server.free_slot() == 0  # retirement freed the slot
        second = serve.Request(rid=1, prompt=rng.integers(0, cfg.vocab_size, size=6))
        out2 = _drive(server, [second])
        assert len(out2[1]) == 1 + self.GEN
        assert out[0] is not out2[1]


def _masked(text: str) -> list[str]:
    """The printed lines with every number replaced by '#'."""
    return [re.sub(r"-?\d+(\.\d+)?", "#", line) for line in text.splitlines()]


def test_main_prints_the_jax_format(monkeypatch):
    argv = ["--arch", "granite3_8b", "--smoke", "--requests", "5", "--slots", "4",
            "--prompt-len", "4", "--gen", "3", "--sampler", "mcmc"]
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    with redirect_stdout(io.StringIO()) as jout:
        jserve.main()
    with redirect_stdout(io.StringIO()) as tout:
        row = serve.main([*argv, "--device", "cpu"])
    assert _masked(tout.getvalue()) == _masked(jout.getvalue())
    assert tout.getvalue().startswith(
        "[serve] 5 requests x 3 tokens on 4 slots (mcmc, backend=auto): 20 tokens in ")
    assert row["tokens"] == 20 and row["samples"] == 5 + row["decode_steps"]
    assert row["device"] == "cpu" and 0 < row["acceptance"] < 1
    assert sorted(row["streams"]) == list(range(5))


def test_server_needs_a_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = configs.get_smoke_config("granite3_8b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.BatchedServer(cfg, serve.ServeConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "granite3_8b", "--smoke", "--requests", "1"])
