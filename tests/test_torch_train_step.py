"""The port's train step against the JAX package's, on the CPU: the dense
and MoE families (gemma2, command-r, granite-3, codeqwen1.5, granite-moe,
phi3.5-moe).  ``test_torch_train_step_mixers.py`` runs the same harness on
the hybrid, RWKV, enc-dec and VLM families.

Each architecture runs its reduced config in f32 at B = 2, T = 24 (as
``test_arch_smoke.py``), from the parameters of ``test_torch_lm_dense``'s
``family`` (the reference's ``materialize`` with a few leaves perturbed),
which reach the port through ``params_from_numpy`` with every leaf in f32.
Batches come from each package's own ``make_batch`` (bit-equal,
``test_torch_data.py``).  The reference runs jitted: ``jax.grad`` of its
``loss_fn`` and its ``make_train_step``.  Tolerances: rtol = atol = 1e-4
on the loss, the metrics, every gradient leaf and, after each of 3 steps,
every parameter and moment leaf; the step counter exactly.  Gradients near
0 could flip AdamW's first update (``m / sqrt(v) ~ sign(g)``) between the
two packages; no such flip showed on these inputs, so no leaf is exempt.
``remat=True`` must equal ``remat=False`` bit for bit on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_batch as jmake_batch
from repro.optim import adamw as jadamw
from repro.train import step as jstep
from repro_torch import configs as tconfigs
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.models import common as tcm
from repro_torch.optim import adamw
from repro_torch.train import step as tstep
from test_torch_lm_dense import TOL, family

ARCHS = ("gemma2-27b", "command-r-35b", "granite-3-2b", "codeqwen1.5-7b",
         "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
B, T, STEPS = 2, 24, 3
STEP_KW = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, xent_chunk=16)
METRICS = ("loss", "tokens", "moe_lb", "moe_z", "moe_dropped", "lr",
           "grad_norm")


def at(tree, path):
    """The leaf of a reference tree (dicts, lists, named tuples) at a path
    of the port's ``common.leaves``."""
    for k in path:
        if isinstance(tree, dict):
            tree = tree[k]
        elif hasattr(tree, "_fields"):
            tree = getattr(tree, k)
        else:
            tree = tree[int(k)]
    return np.asarray(tree)


def assert_tree_close(port_tree, ref_tree, what: str) -> None:
    pairs = tcm.leaves(port_tree)
    assert len(pairs) == len(jax.tree.leaves(ref_tree)), what
    for path, t in pairs:
        want = at(ref_tree, path)
        assert tuple(t.shape) == want.shape, (what, path)
        np.testing.assert_allclose(t.detach().numpy(), want, **TOL,
                                   err_msg=f"{what} {'/'.join(path)}")


def _data(cfg, seed=3):
    return dict(vocab=cfg.vocab, seq_len=T, global_batch=B, seed=seed)


def jbatches(jcfg):
    return [{k: jnp.asarray(v) for k, v in jmake_batch(
        JDataConfig(**_data(jcfg)), i, model_cfg=jcfg).items()}
        for i in range(STEPS)]


def tbatches(tcfg):
    return [make_batch(DataConfig(**_data(tcfg)), i, model_cfg=tcfg)
            for i in range(STEPS)]


@dataclasses.dataclass
class Reference:
    fam: object
    grads: dict            # jax.grad of loss_fn on batch 0
    metrics: dict          # its metrics
    states: list           # the state after each step
    step_metrics: list     # each step's metrics


@functools.lru_cache(maxsize=None)
def reference(arch: str) -> Reference:
    fam = family(arch)
    jcfg = fam.jcfg
    batches = jbatches(jcfg)
    grad_fn = jax.jit(jax.grad(
        lambda p, b: jstep.loss_fn(jcfg, p, b,
                                   xent_chunk=STEP_KW["xent_chunk"]),
        has_aux=True))
    grads, met = grad_fn(fam.jparams, batches[0])
    step_fn = jax.jit(jstep.make_train_step(jcfg, **STEP_KW))
    state = {"params": fam.jparams, "opt": jadamw.init(fam.jparams)}
    states, step_metrics = [], []
    for b in batches:
        state, m = step_fn(state, b)
        states.append(jax.tree.map(np.asarray, state))
        step_metrics.append({k: float(v) for k, v in m.items()})
    return Reference(fam, jax.tree.map(np.asarray, grads),
                     {k: float(v) for k, v in met.items()}, states,
                     step_metrics)


def port_params(ref: Reference):
    return tcm.params_from_numpy(ref.fam.tree, device="cpu",
                                 compute_dtype="float32")


def check_grads(arch: str) -> None:
    ref = reference(arch)
    tcfg = tconfigs.get_reduced(arch)
    grads, met = tstep.loss_and_grads(tcfg, port_params(ref),
                                      tbatches(tcfg)[0],
                                      xent_chunk=STEP_KW["xent_chunk"])
    for k, v in met.items():
        np.testing.assert_allclose(float(v), ref.metrics[k], **TOL,
                                   err_msg=f"{arch} {k}")
    assert_tree_close(grads, ref.grads, f"{arch} grad")


def check_steps(arch: str) -> None:
    ref = reference(arch)
    tcfg = tconfigs.get_reduced(arch)
    params = port_params(ref)
    state = {"params": params, "opt": adamw.init(params)}
    step = tstep.make_train_step(tcfg, **STEP_KW)
    for i, batch in enumerate(tbatches(tcfg)):
        state, met = step(state, batch)
        want = ref.step_metrics[i]
        for k in METRICS:
            np.testing.assert_allclose(float(met[k]), want[k], **TOL,
                                       err_msg=f"{arch} step {i} {k}")
        assert float(met["step"]) == want["step"] == i + 1
        assert state["opt"].step.dtype == torch.int32
        assert int(state["opt"].step) == i + 1
        assert_tree_close(state["params"], ref.states[i]["params"],
                          f"{arch} step {i} params")
        assert_tree_close(state["opt"].m, ref.states[i]["opt"].m,
                          f"{arch} step {i} m")
        assert_tree_close(state["opt"].v, ref.states[i]["opt"].v,
                          f"{arch} step {i} v")


def check_remat(arch: str) -> None:
    """Gradients with remat on ("nothing" and "dots") bit-equal to remat
    off."""
    ref = reference(arch)
    batch = tbatches(tconfigs.get_reduced(arch))[0]
    out = {}
    for key, over in (("off", dict(remat=False)),
                      ("nothing", dict(remat=True, remat_policy="nothing")),
                      ("dots", dict(remat=True, remat_policy="dots"))):
        cfg = tconfigs.get_reduced(arch, **over)
        out[key] = tstep.loss_and_grads(cfg, port_params(ref), batch,
                                        xent_chunk=STEP_KW["xent_chunk"])
    for key in ("nothing", "dots"):
        got = dict(tcm.leaves(out[key][0]))
        for path, g in tcm.leaves(out["off"][0]):
            assert torch.equal(g, got[path]), (arch, key, path)
        for k, v in out["off"][1].items():
            assert torch.equal(v, out[key][1][k]), (arch, key, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    check_steps(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal(arch):
    check_remat(arch)


def test_unknown_remat_policy_raises():
    cfg = tconfigs.get_reduced("granite-3-2b", remat_policy="offloadable")
    params = tstep.init_state(cfg, 0, device="cpu")["params"]
    batch = tbatches(cfg)[0]
    with pytest.raises(ValueError, match="remat_policy"):
        tstep.loss_and_grads(cfg, params, batch)
    # the serving paths (no grad) never reach the policy
    with torch.no_grad():
        tstep.loss_fn(cfg, params, batch)


def test_remat_only_where_autograd_records(monkeypatch):
    """A forward with grad enabled but no input that requires grad (the
    serving paths) runs as without grad, with no checkpoint; a training
    forward checkpoints each repeat of the pattern."""
    from repro_torch.models import lm

    cfg = tconfigs.get_reduced("gemma2-27b")     # 4 layers, 2 repeats
    params = tstep.init_state(cfg, 0, device="cpu")["params"]
    batch = {"tokens": tbatches(cfg)[0]["tokens"]}
    calls = []
    real = lm.ckpt.checkpoint
    monkeypatch.setattr(lm.ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        want, _ = lm.forward(cfg, params, batch)
    got, _ = lm.forward(cfg, params, batch)
    assert not calls and not got.requires_grad
    assert torch.equal(got, want)
    train = tcm.tree_map(lambda _, t: t.detach().requires_grad_(True),
                         params)
    got, _ = lm.forward(cfg, train, batch)
    assert len(calls) == 2 and got.requires_grad
    np.testing.assert_array_equal(got.detach().numpy(), want.numpy())


def test_dots_policy_saves_products_without_batch_dims():
    """"dots" saves what the reference's dots_with_no_batch_dims_saveable
    saves: the projections (``mm``, or einsum's ``bmm`` over a batch of
    one) and not the chunked attention's batched score products, the
    largest activations of a step."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import lm

    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, op, types, args=(), kwargs=None):
            if "mm" in str(op):
                seen.append(lm._save_dots(None, op, *args, **kwargs or {}))
            return op(*args, **(kwargs or {}))

    x, w = torch.randn(2, 5, 8), torch.randn(8, 3, 4)
    q, k = torch.randn(2, 5, 3, 4), torch.randn(2, 6, 3, 4)
    with Record():
        torch.einsum("btd,dhk->bthk", x, w)          # a projection
        x @ torch.randn(8, 7)
        torch.addmm(torch.zeros(7), x[0], torch.randn(8, 7))
    assert seen == [save] * 3
    seen.clear()
    with Record():
        torch.einsum("bqhd,bkhd->bhqk", q, k)        # attention scores
        torch.einsum("bhqk,bkhd->bqhd", torch.randn(2, 3, 5, 6), k)
        torch.baddbmm(torch.zeros(6, 5, 6), torch.randn(6, 5, 4),
                      torch.randn(6, 4, 6))
    assert save not in seen and len(seen) == 3
