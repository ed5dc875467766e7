"""Input shapes of the LM cells (port of ``repro/configs/shapes.py``).

Only :data:`VLM_PATCHES` is here, which the LM data pipeline reads.  The
rest of the reference's module (``SHAPES``, ``ShapeCell``, ``skip_reason``,
``input_specs``) serves its dry-run layer and waits for ROADMAP item 14.7.
"""
from __future__ import annotations

# patch count for the VLM prefix (stubbed SigLIP: 448x448 / 14 -> 1024; the
# paligemma-224 default of 256 patches is used)
VLM_PATCHES = 256
