"""A plain sequential discrete-event simulator of one cloud scenario, the
yardstick that decides whether the benchmarked engine's answers are right.

It re-simulates one lane of a batch from the same trace and parameters
that the engine was given, in NumPy, one event time after another, with
the semantics the benchmark's configurations state (DISSECT-CF, Kecskemeti
2015, SIMPAT 58, §3):

* an event time is reached by the earliest of: a flow's completion at its
  max-min fair rate, a flow's latency gate opening, a PM's power-state
  transition ending, the next task arrival, the stop time;
* at each event time, in order: the fair-share rates of the interval just
  ended drain every live flow, the meters integrate the interval's power,
  finished flows move their VM along its lifecycle (image transfer ->
  boot -> task -> free; a live migration -> the task on the new host),
  finished PM transitions take effect, the PM policy runs (on-demand wake
  and sleep, then the migrating policies' moves) and the VM policy
  dispatches the queue;
* a flow counts as finished once its remaining work is at most
  ``1e-6 * its registered total + 1e-9``;
* the run ends at the first event time after which nothing is queued,
  pending, live or switching, or at which nothing happened and nothing
  changed.

It follows the pattern of an independent sequential DES with its own
max-min solve (progressive filling) and is written from the semantics
above, not from the engine's code: it keeps Python objects for the live
flows and NumPy vectors for the machines, and imports nothing of the
engine.  It computes in float64, or, as the control that the comparison
has to reject, with every stored quantity rounded to bfloat16
(``precision="bfloat16"``).
"""
from __future__ import annotations

import math

import numpy as np

BIG = 3.0e38          # "no limit" for a flow's rate, as the configuration states

# PM power states
PM_OFF, PM_SWITCHING_ON, PM_RUNNING, PM_SWITCHING_OFF = 0, 1, 2, 3
# VM lifecycle stages
VM_FREE, VM_TRANSFER, VM_STARTUP, VM_RUNNING = 0, 1, 2, 3
VM_MIGRATING = 6
# the stages in which a VM's own CPU spreader performs
VM_CPU_ON = (VM_TRANSFER, VM_STARTUP, VM_RUNNING)
# what a VM's flow carries
XFER, BOOT, TASK, MIGRATE = "xfer", "boot", "task", "migrate"
# task states
PENDING, ACTIVE, DONE, REJECTED = 0, 1, 2, 3

VM_POLICIES = ("firstfit", "nonqueuing", "smallestfirst")
PM_POLICIES = ("alwayson", "ondemand", "consolidate", "defrag", "evacuate")
INF = math.inf


def bf16(x):
    """``x`` rounded to the nearest bfloat16 (ties to even), as float64."""
    a = np.asarray(x, np.float64).astype(np.float32)
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    out = bits.astype(np.uint32).view(np.float32).astype(np.float64)
    out = np.where(np.isfinite(a), out, a.astype(np.float64))
    return out if out.ndim else float(out)


def _identity(x):
    return x


class Flow:
    """One VM's consumption: ``rem`` work left at rate <= ``limit`` from
    spreader ``prov`` to spreader ``cons``, counted from ``release``."""

    __slots__ = ("kind", "prov", "cons", "rem", "total", "limit", "release")

    def __init__(self, kind, prov, cons, amount, limit, release):
        self.kind, self.prov, self.cons = kind, prov, cons
        self.rem = self.total = amount
        self.limit, self.release = limit, release

    def finished(self) -> bool:
        return self.rem <= 1e-6 * self.total + 1e-9


def maxmin_rates(flows, capacity, *, max_rounds: int, rel_eps: float,
                 q=_identity):
    """Max-min fair rates of ``flows`` (each with ``prov``, ``cons`` and
    ``limit``) over spreader capacities ``capacity(s)``, by progressive
    filling: every round raises all unfrozen flows by the largest common
    step that no spreader's headroom (its capacity less what it already
    carries, shared among its unfrozen flows) and no flow's own limit
    exceeds, then freezes the flows that step made tight (within
    ``rel_eps``).  At most ``max_rounds`` rounds."""
    n = len(flows)
    rates = np.zeros(n)
    if not n:
        return rates
    ends = sorted({f.prov for f in flows} | {f.cons for f in flows})
    where = {s: i for i, s in enumerate(ends)}
    prov = np.array([where[f.prov] for f in flows])
    cons = np.array([where[f.cons] for f in flows])
    cap = np.array([capacity(s) for s in ends], np.float64)
    limit = np.array([f.limit for f in flows], np.float64)
    unfrozen = np.ones(n, bool)
    m = len(ends)
    for _ in range(max_rounds):
        if not unfrozen.any():
            break
        # each side of a spreader (what it provides, what it consumes)
        # shares its own headroom
        share_p, share_c = (np.full(m, BIG), np.full(m, BIG))
        for side, share in ((prov, share_p), (cons, share_c)):
            cnt = np.bincount(side[unfrozen], minlength=m)
            room = q(np.maximum(cap - np.bincount(side, rates, m), 0.0))
            share[cnt > 0] = q(room / np.maximum(cnt, 1))[cnt > 0]
        step = np.minimum(np.minimum(share_p[prov], share_c[cons]),
                          q(np.maximum(limit - rates, 0.0)))
        step = np.where(unfrozen, step, BIG)
        delta = float(step.min())
        if not math.isfinite(delta) or delta >= BIG:
            delta = 0.0
        rates = np.where(unfrozen, q(rates + delta), rates)
        unfrozen &= ~(step <= delta * (1.0 + rel_eps) + 1e-12)
    return rates


class Lane:
    """One scenario: ``deployment`` (the configuration's cloud), ``point``
    (this lane's parameters and policies) and a trace of float arrays
    ``arrival``, ``cores``, ``work``."""

    def __init__(self, deployment: dict, point: dict, trace: dict, *,
                 precision: str = "float64", max_passes: int | None = None):
        self.q = bf16 if precision == "bfloat16" else _identity
        q = self.q
        cloud = dict(deployment["cloud"], **point)
        self.P = int(deployment["n_pm"])
        self.V = int(deployment["n_vm"])
        self.pm_cores = q(cloud["pm_cores"])
        self.perf_core = q(cloud["perf_core"])
        self.net_bw = q(cloud["net_bw"])
        self.repo_bw = q(cloud["repo_bw"])
        self.image_mb = q(cloud["image_mb"])
        self.boot_work = q(cloud["boot_work"])
        self.latency = q(cloud["latency_s"])
        self.vm_mem_mb = q(cloud["vm_mem_mb"])
        self.idle_frac = q(cloud["consolidate_idle_frac"])
        self.max_migrations = max(1, min(int(deployment["max_migrations"]),
                                         int(deployment["n_vm"])))
        self.vm_policy = cloud["vm_sched"]
        self.pm_policy = cloud["pm_sched"]
        if self.vm_policy not in VM_POLICIES:
            raise ValueError(f"no reference for VM policy {self.vm_policy!r}")
        if self.pm_policy not in PM_POLICIES:
            raise ValueError(f"no reference for PM policy {self.pm_policy!r}")
        if cloud["metering_period"] != 0:
            raise ValueError("the reference has no sampled (polled) meter")
        power = deployment["power"]
        self.p_min = np.array([q(power[s]["p_min"]) for s in
                               ("off", "switching_on", "running",
                                "switching_off")])
        self.p_max = np.array([q(power[s]["p_max"]) for s in
                               ("off", "switching_on", "running",
                                "switching_off")])
        self.linear = np.array([power[s]["linear"] for s in
                                ("off", "switching_on", "running",
                                 "switching_off")], bool)
        self.boot_s = q(power["switching_on"]["seconds"])
        self.halt_s = q(power["switching_off"]["seconds"])
        # indirect meters driven by the IT power: P = base + coeff * IT
        indirect = deployment["meters"]["indirect"]
        if any(m["signal"] != "it_power" for m in indirect):
            raise ValueError("the reference drives indirect meters by the "
                             "IT power only")
        self.indirect = [m["name"] for m in indirect]
        self.ind_coef = [(q(m["base_w"]), q(m["coeff"])) for m in indirect]
        self.max_rounds = int(deployment["max_fill_iters"])
        self.rel_eps = float(deployment["fill_rel_eps"])
        self.max_events = int(deployment["max_events"])
        if max_passes is not None:
            self.max_events = min(self.max_events, int(max_passes))
        self.arrival = q(np.asarray(trace["arrival"], np.float64))
        self.cores = np.asarray(trace["cores"], np.float64)
        self.work = q(np.asarray(trace["work"], np.float64))
        # spreader ids: ("cpu", p), ("netin", p), ("netout", p), ("repo",),
        # ("vm", v)

    # ------------------------------------------------------------------
    def capacity(self, s):
        kind = s[0]
        if kind == "cpu":
            return (self.pm_cores * self.perf_core
                    if self.pstate[s[1]] == PM_RUNNING else 0.0)
        if kind in ("netin", "netout"):
            return self.net_bw if self.pstate[s[1]] != PM_OFF else 0.0
        if kind == "repo":
            return self.repo_bw
        v = s[1]
        return (max(self.vm_cores[v], 1.0) * self.perf_core
                if self.vstage[v] in VM_CPU_ON else 0.0)

    def queued(self, t):
        return np.flatnonzero((self.task_state == PENDING)
                              & (self.arrival <= t))

    def run(self, t_stop: float = math.inf) -> dict:
        q = self.q
        P, V, T = self.P, self.V, len(self.arrival)
        self.pstate = np.full(P, PM_RUNNING if self.pm_policy == "alwayson"
                              else PM_OFF)
        self.pstate_end = np.full(P, math.inf)
        self.free = np.full(P, self.pm_cores)
        self.vstage = np.zeros(V, int)
        self.vm_host = np.zeros(V, int)
        self.vm_cores = np.zeros(V)
        self.vm_task = np.full(V, -1)
        self.task_vm = np.full(T, -1)    # the slot each task's VM took
        self.n_migrations = 0
        self.saved = np.zeros(V)
        self.mig_dst = np.zeros(V, int)
        self.last_w = np.zeros(P)        # the meters' last power readings
        self.last_idle_w = np.zeros(P)
        self.flows: dict[int, Flow] = {}
        self.task_state = np.full(T, PENDING)
        self.t_done = np.full(T, math.inf)
        self.overflow = False
        e_pm = np.zeros(P)
        e_idle = np.zeros(P)
        e_vm = np.zeros(V)
        e_task = np.zeros(T)             # each task's VM's energy
        e_total = 0.0
        e_ind = np.zeros(len(self.ind_coef))
        arrivals = np.sort(self.arrival)

        t = 0.0
        self.pm_pass(t)
        self.vm_pass(t)
        n = 0
        while n < self.max_events:
            snap = (self.task_state.copy(), self.vstage.copy(),
                    self.pstate.copy(), set(self.flows))
            live = [(v, f) for v, f in self.flows.items()
                    if t >= f.release and not f.finished()]
            rates = maxmin_rates([f for _, f in live], self.capacity,
                                 max_rounds=self.max_rounds,
                                 rel_eps=self.rel_eps, q=q)
            # the next event time
            cands = [f.rem / r for (_, f), r in zip(live, rates)
                     if r > 0]
            cands += [f.release - t for f in self.flows.values()
                      if t < f.release]
            trans = (self.pstate == PM_SWITCHING_ON) | (
                self.pstate == PM_SWITCHING_OFF)
            cands += list(self.pstate_end[trans] - t)
            nxt = np.searchsorted(arrivals, t, side="right")
            if nxt < T:
                cands.append(arrivals[nxt] - t)
            if math.isfinite(t_stop):
                cands.append(t_stop - t)
            has_event = bool(cands)
            dt = q(max(min(cands), 0.0)) if cands else 0.0
            t_new = q(t + dt)
            n += 1

            # drain the interval [t, t_new] at its rates
            cpu_del = np.zeros(P)
            for (v, f), r in zip(live, rates):
                f.rem = q(max(f.rem - q(r * dt), 0.0))
                if f.prov[0] == "cpu":
                    cpu_del[f.prov[1]] += r

            # meters over the interval, from its starting state
            util = np.clip(cpu_del / max(self.pm_cores * self.perf_core,
                                         1e-30), 0.0, 1.0)
            st = self.pstate
            idle_w = self.p_min[st]
            span = np.where(self.linear[st], self.p_max[st] - idle_w, 0.0)
            power = q(idle_w + util * span)
            self.last_w, self.last_idle_w = power, idle_w
            e_pm = q(e_pm + q(power * dt))
            e_idle = q(e_idle + q(idle_w * dt))
            it_power = q(float(power.sum()))
            e_total = q(e_total + q(it_power * dt))
            e_ind = q(e_ind + q(np.array([b + c * it_power
                                          for b, c in self.ind_coef]) * dt))
            vm_w = self.vm_power(live, rates, cpu_del, idle_w, span, util)
            for v, w in vm_w.items():
                e_vm[v] = q(e_vm[v] + q(w * dt))
                e_task[self.vm_task[v]] = q(e_task[self.vm_task[v]]
                                            + q(w * dt))

            t = t_new
            self.lifecycle(live, t)
            ends = trans & (self.pstate_end <= t)
            on = ends & (self.pstate == PM_SWITCHING_ON)
            self.pstate[on] = PM_RUNNING
            self.pstate[ends & ~on] = PM_OFF
            self.pstate_end[ends] = math.inf
            self.pm_pass(t)
            self.vm_pass(t)

            # does the run go on?
            more = (any(not f.finished() for f in self.flows.values())
                    or bool(((self.task_state == PENDING)).any())
                    or bool(((self.pstate == PM_SWITCHING_ON)
                             | (self.pstate == PM_SWITCHING_OFF)).any()))
            changed = (not np.array_equal(snap[0], self.task_state)
                       or not np.array_equal(snap[1], self.vstage)
                       or not np.array_equal(snap[2], self.pstate)
                       or snap[3] != set(self.flows))
            if not ((has_event or changed) and more) or t >= t_stop:
                break

        return dict(
            completion=self.t_done, rejected=self.task_state == REJECTED,
            n_events=n, t_end=t, overflow=self.overflow,
            migrations=self.n_migrations, task_vm=self.task_vm,
            task_vm_energy=e_task,
            readings=dict(pm=e_pm, pm_idle=e_idle, iaas_total=e_total,
                          vm=e_vm, vm_unattributed=e_total - e_vm.sum(),
                          **dict(zip(self.indirect, e_ind))))

    # ------------------------------------------------------------------
    def vm_power(self, live, rates, cpu_del, idle_w, span, util):
        """Each VM's share of its host's draw over the interval (Eq. 6):
        the host's variable draw in proportion to the VM's share of the
        host's delivered CPU, plus an equal share of its idle draw among
        the VMs coupled to the host.  A VM is coupled when a live flow
        joins its own CPU to its host's CPU in one influence group."""
        parent = {}

        def find(a):
            parent.setdefault(a, a)
            while parent[a] != a:
                parent[a] = parent[parent[a]]
                a = parent[a]
            return a

        for _, f in live:
            ra, rb = find(f.prov), find(f.cons)
            if ra != rb:
                parent[ra] = rb
        rate_of = {v: r for (v, _), r in zip(live, rates)}
        coupled = [v for v in np.flatnonzero(self.vstage != VM_FREE)
                   if ("vm", v) in parent and ("cpu", self.vm_host[v]) in
                   parent and find(("vm", v)) == find(("cpu", self.vm_host[v]))]
        per_host = np.bincount([self.vm_host[v] for v in coupled],
                               minlength=self.P)
        out = {}
        for v in coupled:
            h = self.vm_host[v]
            frac = rate_of.get(v, 0.0) / max(cpu_del[h], 1e-30)
            out[v] = (span[h] * util[h] * frac
                      + idle_w[h] / max(per_host[h], 1))
        return out

    def lifecycle(self, live, t):
        """Move each VM whose flow just finished to its next stage."""
        for v, f in live:
            if not f.finished():
                continue
            h = self.vm_host[v]
            if f.kind == MIGRATE:
                h = self.vm_host[v] = self.mig_dst[v]
                task = self.vm_task[v]
                self.flows[v] = Flow(TASK, ("cpu", h), ("vm", v),
                                     self.saved[v],
                                     self.q(self.cores[task] * self.perf_core),
                                     t)
                self.flows[v].total = max(self.saved[v], 1e-9)
                self.vstage[v] = VM_RUNNING
            elif f.kind == XFER:
                self.flows[v] = Flow(BOOT, ("cpu", h), ("vm", v),
                                     self.boot_work, BIG, t)
                self.vstage[v] = VM_STARTUP
            elif f.kind == BOOT:
                task = self.vm_task[v]
                self.flows[v] = Flow(TASK, ("cpu", h), ("vm", v),
                                     self.work[task],
                                     self.q(self.cores[task] * self.perf_core),
                                     t)
                self.vstage[v] = VM_RUNNING
            else:
                task = self.vm_task[v]
                self.free[h] = self.q(self.free[h] + self.vm_cores[v])
                self.task_state[task] = DONE
                self.t_done[task] = t
                self.vstage[v] = VM_FREE
                del self.flows[v]

    def pm_pass(self, t):
        """The PM policy: on-demand wakes enough OFF machines (lowest
        index first) for the queued cores that the running and booting
        machines cannot take, and switches off running machines that host
        no VM while nothing is queued; the migrating policies then move
        running VMs (:meth:`migrations`)."""
        if self.pm_policy == "alwayson":
            return
        self.wake_sleep(t)
        if self.pm_policy != "ondemand":
            self.migrations(t)

    def wake_sleep(self, t):
        queued = self.queued(t)
        need = float(self.cores[queued].sum())
        soon = (self.pstate == PM_RUNNING) | (self.pstate == PM_SWITCHING_ON)
        deficit = need - float(self.free[soon].sum())
        wake_n = math.ceil(max(deficit, 0.0) / self.pm_cores)
        hosted = np.bincount(self.vm_host[self.vstage != VM_FREE],
                             minlength=self.P)
        idle = (self.pstate == PM_RUNNING) & (hosted == 0) & (len(queued) == 0)
        wake = np.flatnonzero(self.pstate == PM_OFF)[:wake_n]
        self.pstate[wake] = PM_SWITCHING_ON
        self.pstate_end[wake] = self.q(t + self.boot_s)
        self.pstate[idle] = PM_SWITCHING_OFF
        self.pstate_end[idle] = self.q(t + self.halt_s)

    def migrations(self, t):
        """The migrating PM policies.  A donor is a running PM hosting a
        running VM; under ``consolidate`` and ``evacuate`` only one whose
        last meter reading is idle-dominated (idle draw over draw above
        ``consolidate_idle_frac``).  The source is the least-loaded donor
        (fewest cores allocated; lowest index on ties), its victim its
        running VM of fewest cores (lowest slot).  A destination is a
        running PM other than the source, at least as loaded, with the
        cores free: the one of fewest free cores (``consolidate``,
        ``evacuate``) or the most loaded (``defrag``, and only while
        nothing is queued).  ``evacuate`` moves up to ``max_migrations``
        of the source's running VMs, smallest first, each planned against
        the cores the moves before it took."""
        running = self.pstate == PM_RUNNING
        used = self.pm_cores - self.free
        movable = self.vstage == VM_RUNNING
        n_movable = np.bincount(self.vm_host[movable], minlength=self.P)
        donor = running & (n_movable > 0)
        if self.pm_policy == "defrag":
            if len(self.queued(t)):
                return
        else:
            frac = self.last_idle_w / np.maximum(self.last_w, 1e-30)
            donor &= frac > self.idle_frac
        if not donor.any():
            return
        src = int(np.argmin(np.where(donor, used, INF)))
        on_src = np.flatnonzero(movable & (self.vm_host == src))
        if not len(on_src):
            return
        # victims by cores, ties to the lower slot
        victims = on_src[np.argsort(self.vm_cores[on_src], kind="stable")]
        pm = np.arange(self.P)

        def destination(need, free):
            fit = (running & (free >= need) & (pm != src)
                   & (used >= used[src]))
            if not fit.any():
                return None
            if self.pm_policy == "defrag":
                return int(np.argmax(np.where(fit, used, -INF)))
            return int(np.argmin(np.where(fit, free, INF)))

        if self.pm_policy != "evacuate":
            dst = destination(self.vm_cores[victims[0]], self.free)
            if dst is not None:
                self.migrate(victims[0], dst, t)
            return
        plan, free = [], self.free.copy()
        for v in victims[:self.max_migrations]:
            dst = destination(self.vm_cores[v], free)
            if dst is not None:
                free[dst] -= self.vm_cores[v]
                plan.append((v, dst))
        for v, dst in plan:
            self.migrate(v, dst, t)

    def migrate(self, v, dst, t):
        """Begin live-migrating VM ``v`` to PM ``dst`` (if it still runs
        and ``dst`` still has the cores): the cores move at once, the
        VM's task pauses with its remaining work kept, and its memory
        crosses from the source's NIC to the destination's."""
        c = self.vm_cores[v]
        if self.vstage[v] != VM_RUNNING or self.free[dst] < c:
            return
        src = self.vm_host[v]
        self.saved[v] = self.flows[v].rem
        self.free[src] = self.q(self.free[src] + c)
        self.free[dst] = self.q(self.free[dst] - c)
        self.vstage[v] = VM_MIGRATING
        self.n_migrations += 1
        self.mig_dst[v] = dst
        self.flows[v] = Flow(MIGRATE, ("netout", src), ("netin", dst),
                             self.vm_mem_mb, BIG, self.q(t + self.latency))

    def vm_pass(self, t):
        """The VM policy: serve the queue (by arrival, or by fewest cores
        for ``smallestfirst``; ties to the lower task index) onto the
        first running PM with the cores free, into the lowest free VM
        slot, until the head cannot be placed.  A task larger than a PM
        is rejected; ``nonqueuing`` also rejects a head that fits no PM
        now."""
        release = self.q(t + self.latency)
        key = self.cores if self.vm_policy == "smallestfirst" else self.arrival
        while True:
            queued = self.queued(t)
            if not len(queued):
                return
            head = queued[np.argmin(key[queued])]
            c = self.cores[head]
            fit = np.flatnonzero((self.pstate == PM_RUNNING)
                                 & (self.free >= c))
            if c > self.pm_cores or (self.vm_policy == "nonqueuing"
                                     and not len(fit)):
                self.task_state[head] = REJECTED
                continue
            if not len(fit):
                return
            slots = np.flatnonzero(self.vstage == VM_FREE)
            if not len(slots):
                self.overflow = True
                return
            pm, v = fit[0], slots[0]
            self.task_state[head] = ACTIVE
            self.vstage[v] = VM_TRANSFER
            self.vm_task[v] = head
            self.task_vm[head] = v
            self.vm_host[v] = pm
            self.vm_cores[v] = c
            self.free[pm] = self.q(self.free[pm] - c)
            self.flows[v] = Flow(XFER, ("repo",), ("netin", pm),
                                 self.image_mb, BIG, release)


def simulate(deployment: dict, point: dict, trace: dict, *,
             precision: str = "float64", max_passes: int | None = None,
             t_stop: float = math.inf) -> dict:
    """Run one lane to its end; the answers of :meth:`Lane.run`."""
    return Lane(deployment, point, trace, precision=precision,
                max_passes=max_passes).run(t_stop)
