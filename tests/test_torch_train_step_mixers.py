"""The port's train step against the JAX package's, on the CPU: the hybrid
(Jamba: Mamba and attention, with MoE), RWKV-6, enc-dec (seamless) and VLM
(paligemma) families, through the harness of ``test_torch_train_step.py``
(its docstring gives the inputs and tolerances).  The Mamba layers train
through ``attn_impl="chunked"``'s plain scan, RWKV through its host window
loop, at the reduced sizes.
"""
from __future__ import annotations

import pytest

from test_torch_train_step import check_grads, check_remat, check_steps

ARCHS = ("jamba-v0.1-52b", "rwkv6-3b", "seamless-m4t-large-v2",
         "paligemma-3b")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    check_grads(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_reference(arch):
    check_steps(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_is_bit_equal(arch):
    check_remat(arch)
