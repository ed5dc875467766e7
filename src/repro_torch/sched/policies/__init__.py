"""Builtin scheduler policies, registered in the reference's code order:

========  =====  ==================================================
layer     code   policy
========  =====  ==================================================
``vm``    0      ``firstfit`` — queueing first-fit dispatch
``vm``    1      ``nonqueuing`` — reject requests that cannot start
``vm``    2      ``smallestfirst`` — serve the smallest queued task
``pm``    0      ``alwayson`` — the identity: machines never change
``pm``    1      ``ondemand`` — wake against the queue, sleep loadless
``pm``    2      ``consolidate`` — not ported yet (raises)
``pm``    3      ``defrag`` — not ported yet (raises)
``pm``    4      ``evacuate`` — not ported yet (raises)
========  =====  ==================================================
"""
from . import baseline  # noqa: F401
from .. import registry as _registry


def _not_ported(name: str):
    def policy(spec, params, ctx, st):
        raise NotImplementedError(
            f"PM policy {name!r} is not ported to repro_torch yet "
            f"(ROADMAP.md queue 1 item 8: migrating PM policies)")
    policy.__name__ = name
    return policy


for _name in ("consolidate", "defrag", "evacuate"):
    _registry.register("pm", _name, _not_ported(_name),
                       doc="not ported yet: ROADMAP.md queue 1 item 8")
