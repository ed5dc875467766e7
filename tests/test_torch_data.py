"""The port's LM data pipeline against the JAX package's, on the CPU:
``make_batch`` and ``DataIterator`` bit-equal (every key, dtype, shape and
value) for the dense, VLM (patches, a zero-masked prefix) and enc-dec
(frames) families, across steps, hosts and seeds."""
from __future__ import annotations

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs import shapes as jshapes
from repro.data import pipeline as jpipe
from repro_torch import configs as tconfigs
from repro_torch.configs import shapes as tshapes
from repro_torch.data import pipeline as tpipe

FAMILIES = {"dense": "granite-3-2b", "moe": "granite-moe-1b-a400m",
            "vlm": "paligemma-3b", "encdec": "seamless-m4t-large-v2",
            "ssm": "rwkv6-3b", "hybrid": "jamba-v0.1-52b"}


def assert_batches_equal(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_vlm_patches_copied():
    assert tshapes.VLM_PATCHES == jshapes.VLM_PATCHES == 256


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("seed", [0, 7])
def test_make_batch_bit_equal(family, seed):
    arch = FAMILIES[family]
    jcfg, tcfg = jconfigs.get_reduced(arch), tconfigs.get_reduced(arch)
    for seq, batch, n_hosts in ((24, 2, 1), (40, 4, 2), (1100, 2, 1)):
        jd = jpipe.DataConfig(vocab=jcfg.vocab, seq_len=seq,
                              global_batch=batch, seed=seed)
        td = tpipe.DataConfig(vocab=tcfg.vocab, seq_len=seq,
                              global_batch=batch, seed=seed)
        for step in (0, 1, 17):
            for host in range(n_hosts):
                got = tpipe.make_batch(td, step, host=host, n_hosts=n_hosts,
                                       model_cfg=tcfg)
                want = jpipe.make_batch(jd, step, host=host,
                                        n_hosts=n_hosts, model_cfg=jcfg)
                assert_batches_equal(got, want)
                if family == "vlm":
                    P = min(256, seq // 4)
                    assert got["patches"].shape == (batch // n_hosts, P,
                                                    tcfg.d_model)
                    assert not got["loss_mask"][:, :P].any()
                    assert not got["targets"][:, :P].any()
                if family == "encdec":
                    assert got["frames"].shape == (batch // n_hosts, seq,
                                                   tcfg.d_model)


def test_make_batch_without_model_config_and_full_vocab():
    for vocab in (512, 49155, 256000):
        jd = jpipe.DataConfig(vocab=vocab, seq_len=64, global_batch=3,
                              seed=2, planted_period=3)
        td = tpipe.DataConfig(vocab=vocab, seq_len=64, global_batch=3,
                              seed=2, planted_period=3)
        assert_batches_equal(tpipe.make_batch(td, 5),
                             jpipe.make_batch(jd, 5))


def test_data_iterator_matches():
    jcfg = jconfigs.get_reduced("paligemma-3b")
    tcfg = tconfigs.get_reduced("paligemma-3b")
    kw = dict(vocab=jcfg.vocab, seq_len=32, global_batch=4, seed=1)
    jit = jpipe.DataIterator(jpipe.DataConfig(**kw), model_cfg=jcfg,
                             host=1, n_hosts=2, start_step=3)
    tit = tpipe.DataIterator(tpipe.DataConfig(**kw), model_cfg=tcfg,
                             host=1, n_hosts=2, start_step=3)
    assert iter(tit) is tit
    for _ in range(4):
        assert_batches_equal(next(tit), next(jit))
    assert tit.step == jit.step == 7


def test_batch_split_over_hosts_is_checked():
    td = tpipe.DataConfig(vocab=64, seq_len=8, global_batch=3)
    with pytest.raises(ValueError, match="hosts"):
        tpipe.make_batch(td, 0, n_hosts=2)
