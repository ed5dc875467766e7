"""The engine's staged pipeline (port of ``repro.core.loop``): one module
per stage, each ``stage(ctx, st) -> (ctx, st)`` over
:class:`~repro_torch.core.loop.state.CloudState`."""
from .driver import STAGES, make_body, management_pass, termination  # noqa: F401
from .state import (  # noqa: F401
    BIG, KIND_MIGRATE, TASK_ACTIVE, TASK_DONE, TASK_PENDING, TASK_REJECTED,
    CloudState, StageCtx)
