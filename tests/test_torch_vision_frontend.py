"""internvl2-76b's stub vision frontend against the JAX package on the
CPU, on ``smoke_config("internvl2-76b")`` (2 global layers, d 64, GQA
4/2, ``frontend_dim`` 16, untied head), float32 with TF32 off unless a
test says bf16.

* ``init_params``' tree, with ``frontend_proj`` (``{"w","b"}``, a bias
  though the other linears have none), against the reference's through
  ``params_from_jax``: names, shapes and dtypes, float32 and bf16; the
  converted leaf equal to the reference's.
* ``forward_train`` on ``SyntheticLM`` batches (``frontend_embeds`` +
  ``labels``: the embeds project in place of the token embedding,
  unscaled) and on tokens alone: loss and accuracy within ``TOL`` =
  1e-5 and every gradient within 1e-4 of each leaf's largest magnitude
  of ``jax.value_and_grad`` of the reference's (the token embedding's
  gradient is 0 where embeds replace it, on both sides).
* ``forward_prefill`` with ``frontend_embeds``, with no ``logits_index``,
  a scalar and a ``(B,)`` vector: logits and caches within ``TOL``.
* bf16: the port casts the float32 embeds to the weights' dtype before
  ``frontend_proj`` (K1 takes one dtype); the reference projects them
  against promoted weights, so its whole stream is float32.  The
  projection and the prefill logits stay within ``BF16_EMBED_REL`` of
  their largest magnitude of the reference's, the loss within
  ``BF16_LOSS_REL``.
* The three engines serve it on tokens (the reference's engines pass
  no embeds either) with completions and shared stats equal to the JAX
  engine's of the same kind (``check_parity``).
* ``Trainer`` on the synthetic stream with embeds, and both launchers,
  on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serve_parity import (check_parity, engines, prompts_of,
                                 serve_both, WORKLOAD)
from repro.configs import smoke_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
from repro.models import forward_prefill as jax_prefill
from repro.models import forward_train as jax_forward_train
from repro.models import init_params as jax_init
from repro.models.transformer import _embed_inputs as jax_embed_inputs
from repro_torch.configs import smoke_config as torch_smoke_config
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import forward_prefill, forward_train, init_params
from repro_torch.models.transformer import _embed_inputs
from repro_torch.optim import adamw
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import loss_and_grads, Trainer, TrainerConfig

from _torch_threads import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

NAME = "internvl2-76b"
TOL = 1e-5
GRAD_TOL = 1e-4
# bf16: the embeds rounded to bf16 before the projection, the output
# rounded again, against a float32 stream (module doc).
BF16_EMBED_REL = 2.0 ** -5
BF16_LOSS_REL = 2.0 ** -7
B, S = 2, 24


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = prev


def _model(dtype="float32"):
    cfg = dataclasses.replace(smoke_config(NAME), param_dtype=dtype)
    tcfg = dataclasses.replace(torch_smoke_config(NAME), param_dtype=dtype)
    return cfg, tcfg, jax_init(cfg, jax.random.PRNGKey(0))


def _to_torch(jtree, tcfg):
    return params_from_jax(jax.tree.map(np.asarray, jtree), tcfg,
                           device="cpu")


def _batch(cfg, embeds=True, s=S, step=0):
    """A reference ``SyntheticLM`` batch (tokens, frontend_embeds,
    labels), or its tokens alone."""
    out = JaxSyntheticLM(cfg, B, s, JaxDataConfig(seed=3)).batch(step)
    assert set(out) == {"tokens", "frontend_embeds", "labels"}
    return out if embeds else {"tokens": out["tokens"]}


def _spec(tree):
    if isinstance(tree, dict):
        return {k: _spec(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_spec(v) for v in tree]
    return (tuple(tree.shape), tree.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_the_references_tree(dtype):
    cfg, tcfg, jparams = _model(dtype)
    want = _to_torch(jparams, tcfg)
    got = init_params(tcfg, seed=1, device="cpu")
    assert _spec(got) == _spec(want)
    proj = got["frontend_proj"]
    assert set(proj) == set(jparams["frontend_proj"]) == {"w", "b"}
    assert tuple(proj["w"].shape) == (cfg.frontend_dim, cfg.d_model)
    assert proj["w"].dtype == proj["b"].dtype == getattr(torch, dtype)
    assert "b" not in got["layers"][0]["mixer"]["q"]      # no other bias


def test_params_from_jax_carries_frontend_proj():
    _, tcfg, jparams = _model()
    got = _to_torch(jparams, tcfg)["frontend_proj"]
    for k in ("w", "b"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(jparams["frontend_proj"][k]))


@pytest.mark.parametrize("embeds", [True, False], ids=["embeds", "tokens"])
def test_forward_train_loss_and_grads_match_jax_grad(embeds):
    cfg, tcfg, jparams = _model()
    batch = _batch(cfg, embeds)

    def loss_fn(p):
        return jax_forward_train(p, cfg, {k: jnp.asarray(v)
                                          for k, v in batch.items()},
                                 remat="none")

    (jloss, jmet), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        jparams)
    loss, metrics, grads = loss_and_grads(
        _to_torch(jparams, tcfg), tcfg,
        {k: torch.from_numpy(v) for k, v in batch.items()}, remat="full")
    assert abs(float(loss) - float(jloss)) <= TOL
    for k in ("loss", "accuracy", "moe_aux"):
        assert abs(float(metrics[k]) - float(jmet[k])) <= TOL, k
    ref = _to_torch(jgrads, tcfg)
    for g, r in zip(tree_leaves(grads), tree_leaves(ref), strict=True):
        np.testing.assert_allclose(
            g.numpy(), r.numpy(), rtol=0,
            atol=GRAD_TOL * max(r.abs().max().item(), 1e-30))
    embed_grad = grads["embed"]["table"]
    assert bool((embed_grad == 0).all()) == embeds
    assert bool((grads["frontend_proj"]["w"] == 0).all()) != embeds


@pytest.mark.parametrize("index", ["none", "scalar", "vector"])
def test_forward_prefill_with_embeds_matches_jax(index):
    cfg, tcfg, jparams = _model()
    batch = _batch(cfg)
    last = {"none": None, "scalar": np.int32(S - 5),
            "vector": np.array([S - 1, 7], np.int32)}[index]
    jlog, jcache = jax_prefill(
        jparams, cfg, {k: jnp.asarray(v) for k, v in batch.items()},
        cache_len=32, logits_index=None if last is None
        else jnp.asarray(last))
    tlog, tcache = forward_prefill(
        _to_torch(jparams, tcfg), tcfg,
        {k: torch.from_numpy(v) for k, v in batch.items()}, cache_len=32,
        logits_index=None if last is None else torch.from_numpy(
            np.asarray(last)))
    v = cfg.vocab_size
    np.testing.assert_allclose(tlog.numpy()[..., :v],
                               np.asarray(jlog)[..., :v], rtol=TOL, atol=TOL)
    want = cache_from_jax(jax.tree.map(np.asarray, jcache), tcfg,
                          device="cpu")
    assert set(tcache) == set(want) == {"k", "v"}
    for k in want:
        np.testing.assert_allclose(tcache[k].numpy(), want[k].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=k)
    # The tokens do not reach a prefill that has embeds.
    other = dict(batch, tokens=batch["tokens"][::-1].copy())
    again, _ = forward_prefill(
        _to_torch(jparams, tcfg), tcfg,
        {k: torch.from_numpy(x) for k, x in other.items()}, cache_len=32,
        logits_index=None if last is None else torch.from_numpy(
            np.asarray(last)))
    assert torch.equal(again, tlog)


def test_bf16_embeds_cast_stays_near_the_reference():
    cfg, tcfg, jparams = _model("bfloat16")
    batch = _batch(cfg, s=40)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tparams = _to_torch(jparams, tcfg)

    def near(got, want, what):
        got = got.float().numpy()
        want = np.asarray(jnp.asarray(want, jnp.float32))
        err = np.abs(got - want).max()
        assert err <= BF16_EMBED_REL * np.abs(want).max(), (what, err)

    got = _embed_inputs(tparams, tcfg, tb)
    want = jax_embed_inputs(jparams, cfg, jb)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.float32
    near(got, want, "frontend_proj")
    jlog, _ = jax_prefill(jparams, cfg, jb)
    tlog, _ = forward_prefill(tparams, tcfg, tb)
    near(tlog[..., :cfg.vocab_size], jlog[..., :cfg.vocab_size], "logits")
    jloss, _ = jax_forward_train(jparams, cfg, jb, remat="none")
    tloss, _ = forward_train(tparams, tcfg, tb, remat="none")
    assert abs(float(tloss) - float(jloss)) <= BF16_LOSS_REL * abs(
        float(jloss))


@pytest.mark.parametrize("kind", ["slot", "sequential", "paged"])
def test_engines_serve_tokens_as_jax_does(kind):
    cfg = smoke_config(NAME)
    jeng, teng = engines(NAME, kind)
    for work, share in ((WORKLOAD, True),
                        ([(63, 3), (64, 2), (40, 30), (5, 6)], False)):
        if kind == "paged" and work is not WORKLOAD:
            work = work[2:]                # past the page table: both raise
        prompts = prompts_of(work, cfg.vocab_size, seed=4, share=share)
        jout, tout = serve_both(jeng, teng, work, prompts)
        check_parity(jeng, jout, teng, tout)
        assert len(tout) == len(work)


def test_trainer_with_embeds_lowers_the_loss():
    tcfg = torch_smoke_config(NAME)
    tr = Trainer(tcfg, TrainerConfig(steps=12, global_batch=4, seq_len=24,
                                     log_every=100, accum_steps=2),
                 opt_cfg=adamw.AdamWConfig(lr=3e-3, warmup_steps=2,
                                           total_steps=12), device="cpu")
    assert "frontend_embeds" in tr.data.batch(0)
    out = tr.run()
    assert out["final_loss"] < out["first_loss"], out["history"]


@pytest.mark.parametrize("engine", ["slot", "sequential", "paged"])
def test_launchers_run_on_the_cpu(engine, capsys):
    assert launch_serve.main(["--arch", NAME, "--smoke", "--requests", "3",
                              "--max-seq", "64", "--engine", engine,
                              "--device", "cpu"]) == 0
    if engine == "slot":
        assert launch_train.main(["--arch", NAME, "--smoke", "--steps", "2",
                                  "--batch", "2", "--seq", "16",
                                  "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "3/3 done" in out
