"""The bf16 cases that hold the wgmma flash kernel to its plain version.

One list, shared by ``chip_smoke.py`` (on the card: each case through the
wgmma kernel against :func:`..attention.flash_attention_plain` within
``FLASH_TOL``, its visited tiles against the host's count, two launches
bit-identical) and ``tests/test_torch_flash_wgmma.py`` (on the CPU: the plain
version against the Pallas kernel in interpret mode and ``ref.attention_ref``
at the same cases).  Head dims 64 and 128, T <= 320; each case is ragged
against the kernel's 128 x 128 tiles and every row sees at least one key.
"""
from __future__ import annotations

# (B, Tq, Tk, Hq, Hkv, D, options)
WGMMA_CASES = [
    (1, 200, 200, 4, 4, 64, dict(causal=True)),                   # g = 1
    (2, 300, 300, 8, 4, 128, dict(causal=True)),                  # g = 2
    (1, 257, 257, 8, 2, 64, dict(causal=True)),                   # g = 4
    (1, 190, 190, 16, 2, 128, dict(causal=True)),                 # g = 8
    (1, 320, 320, 8, 1, 64, dict(causal=True)),                   # MQA
    (1, 130, 130, 4, 1, 128, dict(causal=True)),                  # MQA
    (1, 33, 33, 2, 1, 64, dict(causal=True)),                     # Tq < 64
    (1, 300, 300, 4, 2, 128, dict(causal=True, window=100)),      # window
    (1, 320, 320, 4, 4, 64, dict(causal=True, window=150)),
    (1, 250, 250, 8, 4, 128, dict(causal=True, softcap=50.0,
                                  scale=144.0 ** -0.5)),          # gemma2
    (1, 160, 160, 4, 2, 64, dict(causal=True, window=64,
                                 softcap=30.0)),
    (1, 300, 300, 4, 4, 128, dict(causal=True, prefix_len=150)),  # > bk
    (1, 320, 320, 4, 1, 64, dict(causal=True, prefix_len=200)),
    (2, 70, 250, 8, 4, 128, dict(causal=True, q_offset=180)),     # offset
    (1, 100, 300, 4, 2, 64, dict(causal=True, q_offset=200)),
    (1, 200, 280, 4, 2, 128, dict(causal=True, window=90, prefix_len=70,
                                  q_offset=80)),
    (2, 190, 190, 4, 4, 64, dict(causal=False)),                  # encoder
    (1, 130, 130, 8, 8, 128, dict(causal=False, scale=0.1)),
    (1, 100, 260, 4, 4, 64, dict(causal=False)),                  # cross
    (1, 64, 300, 4, 4, 128, dict(causal=False)),
]
