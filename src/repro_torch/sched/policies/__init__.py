"""Builtin scheduler policies, registered in the reference's code order:

========  =====  ==================================================
layer     code   policy
========  =====  ==================================================
``vm``    0      ``firstfit`` — queueing first-fit dispatch
``vm``    1      ``nonqueuing`` — reject requests that cannot start
``vm``    2      ``smallestfirst`` — serve the smallest queued task
``pm``    0      ``alwayson`` — the identity: machines never change
``pm``    1      ``ondemand`` — wake against the queue, sleep loadless
``pm``    2      ``consolidate`` — on-demand + one idle-meter-driven
                 live migration per pass
``pm``    3      ``defrag`` — on-demand + bin-packing migrations
                 toward the most-loaded feasible host
``pm``    4      ``evacuate`` — on-demand + multi-VM donor drain (up
                 to ``CloudSpec.max_migrations`` moves per pass)
========  =====  ==================================================
"""
from . import baseline, consolidate, defrag, evacuate  # noqa: F401
from .. import registry as _registry

# the last statement: arms the builtin-unregister protection only once
# every builtin above has registered
_registry._builtins_loaded()
