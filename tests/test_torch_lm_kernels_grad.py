"""The kernel wrappers have no backward (nor has the reference's Pallas
code), so ``flash_attention`` and ``linear_scan`` refuse, on either device,
inputs that require grad while grad is enabled: a gradient through them
would otherwise stop at the kernel without an error.  They accept the same
inputs detached or under ``torch.no_grad()``; their plain versions stay
differentiable, and the model's plain paths (``attn_impl="chunked"``)
train.  Here on CPU tensors; ``chip_smoke.py``'s ``train`` phase checks the
card."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import attention as kattn
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import ssm as kssm
from repro_torch.models import attention as mattn
from repro_torch.train import step as tstep


def _flash_inputs(requires_grad: bool):
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 12, h, 16).astype(np.float32))
               for h in (4, 2, 2))
    return [t.requires_grad_(requires_grad) for t in (q, k, v)]


def _scan_inputs(requires_grad: bool, which: str):
    rng = np.random.RandomState(1)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, 9, 5)).astype(np.float32))
    x = torch.from_numpy(rng.randn(2, 9, 5).astype(np.float32))
    h0 = torch.from_numpy(rng.randn(2, 5).astype(np.float32))
    out = {"a": a, "x": x, "h0": h0}
    out[which].requires_grad_(requires_grad)
    return out


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_attention_refuses_inputs_that_require_grad(which):
    q, k, v = _flash_inputs(False)
    [q, k, v][which].requires_grad_(True)
    with pytest.raises(RuntimeError, match='attn_impl="chunked"'):
        kattn.flash_attention(q, k, v, causal=True)
    want = kattn.flash_attention_plain(q.detach(), k.detach(), v.detach())
    with torch.no_grad():
        got = kattn.flash_attention(q, k, v, causal=True)
    assert torch.equal(got, want)
    got = kattn.flash_attention(q.detach(), k.detach(), v.detach())
    assert torch.equal(got, want)


@pytest.mark.parametrize("which", ["a", "x", "h0"])
def test_linear_scan_refuses_inputs_that_require_grad(which):
    t = _scan_inputs(True, which)
    with pytest.raises(RuntimeError, match='attn_impl="chunked"'):
        kssm.linear_scan(t["a"], t["x"], t["h0"])
    want = kssm.linear_scan_plain(*(t[k].detach() for k in ("a", "x",
                                                             "h0")))
    with torch.no_grad():
        got = kssm.linear_scan(t["a"], t["x"], t["h0"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_plain_versions_stay_differentiable():
    q, k, v = _flash_inputs(True)
    kattn.flash_attention_plain(q, k, v).sum().backward()
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in (q, k, v))
    t = _scan_inputs(True, "x")
    y, h = kssm.linear_scan_plain(t["a"], t["x"], t["h0"])
    (y.sum() + h.sum()).backward()
    assert t["x"].grad is not None


def test_model_paths_refuse_grad_through_pallas_and_train_chunked():
    """The model's pallas route raises under grad (attention and Mamba's
    scan); the chunked route, the training default, trains and launches
    neither kernel wrapper."""
    q, k, v = _flash_inputs(True)
    with pytest.raises(RuntimeError, match="flash_attention"):
        mattn.attention(q, k, v, impl="pallas")
    mattn.attention(q, k, v, impl="chunked").sum().backward()
    cfg = configs.get_reduced("jamba-v0.1-52b", attn_impl="pallas")
    state = tstep.init_state(cfg, 0, device="cpu")
    batch = {"tokens": np.array([[3, 1, 4, 1, 5, 9]]),
             "targets": np.array([[1, 4, 1, 5, 9, 2]]),
             "loss_mask": np.ones((1, 6), np.float32)}
    with pytest.raises(RuntimeError, match="no backward"):
        tstep.loss_and_grads(cfg, state["params"], batch)
    reset_launch_counts()
    chunked = configs.get_reduced("jamba-v0.1-52b")
    assert chunked.attn_impl == "chunked"
    grads, met = tstep.loss_and_grads(chunked, state["params"], batch)
    assert np.isfinite(float(met["loss"]))
    assert launch_counts()["flash_attention"] == 0
    assert launch_counts()["linear_scan"] == 0
    # Mamba's scan of the chunked route is differentiable
    assert float(torch.abs(grads["blocks"][0]["mamba"]["a_log"]).sum()) > 0
