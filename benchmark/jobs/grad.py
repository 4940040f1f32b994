"""Job kind ``grad``: inverse-rendering gradient steps.

The parameters are the material table's albedo rows and the sphere
centres, perturbed from the seed (``init``: made here from the
configuration's recipe, and handed to the program and to the reference
alike); the target is the unperturbed scene's image.  Steps run through
``mrt_torch.inverse.optimize`` with Adam: each call takes ``k`` steps,
``k`` fixed from set-up's step time so that a call is about a quarter of
the window, and the optimizer's state is carried from call to call, so
the window continues the trajectory that set-up started.  A step ends
when its loss is on the host.

Every call keeps what the reference follows of its first
``check_steps`` steps: the state it started from (the parameters, Adam's
moments and the render seed), each step's loss, each leaf's first
gradient as Adam got it (worked out from its first moment before and
after that step) and each leaf's change over those steps.  The check
follows two calls: set-up's first, from the perturbed start, and the
window's last, from the program's own state there, which covers the
window's steps and the hand-over of Adam's state from call to call.

Traffic parameters: spp, max_depth, learning_rate, albedo_spread (a
relative perturbation), centre_spread (an absolute one), check_steps,
block (the reference's pixels a block).
"""

from __future__ import annotations

import statistics
import sys

import torch

from benchmark.harness import device, trace
from benchmark.harness import window as loop
from benchmark.reference import gradient, scenes

BETA1 = 0.9  # Adam's default, which optimize uses


def perturbed(ref, seed, traffic, dev):
    """(albedo (M, 4), centre (S, 3)): the recipe's, perturbed from the
    seed; alpha stays 1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    m, c = ref["materials"]["albedo"], ref["spheres"]["center"]
    u = lambda shape: 2.0 * torch.rand(shape, generator=gen, device=dev) - 1.0
    albedo = torch.clamp(m * (1.0 + traffic["albedo_spread"] * u(m.shape)),
                         0.0, 1.0)
    albedo = torch.cat([albedo, torch.ones_like(albedo[:, :1])], dim=1)
    return albedo, c + traffic["centre_spread"] * u(c.shape)


class State:
    def __init__(self, cell, seed, dev):
        from mrt_torch import inverse
        from mrt_torch.scenes import get

        self.cell, self.folders = cell, cell.spec.folders
        self.config, self.traffic = cell.config, cell.traffic
        c, t = self.config, self.traffic
        self.width, self.height, self.dev = c["width"], c["height"], dev
        self.scene, self.camera = get(c["scene"])(
            aspect_ratio=self.width / self.height,
            **c.get("scene_args", {})).generate(device=dev)
        self.seed = seed
        self.init = perturbed(scenes.build(c, dev, folders=self.folders),
                              seed, t, dev)
        self.params = self.init
        self.target = inverse.render_image(
            self.scene, self.camera, self.width, self.height, spp=t["spp"],
            seed=seed, max_depth=t["max_depth"]).detach()
        self.opt = None
        self.next_seed = seed + 1  # step i renders with seed + 1 + i
        self.step_ends = []
        self.first = self.last = None  # set-up's first call; the latest

    def apply(self, params):
        albedo, centre = params
        s = self.scene
        return s.replace(materials=s.materials.replace(albedo=albedo),
                         spheres=s.spheres.replace(center=centre))

    def optimizer(self, leaves):
        """Adam on this call's leaves, with the state the last call left."""
        opt = torch.optim.Adam(leaves, lr=self.traffic["learning_rate"])
        if self.opt is not None:
            opt.load_state_dict(self.opt.state_dict())
        self.opt = opt
        return opt

    def steps(self, k, callback=None):
        """k steps through one optimize call; returns their losses."""
        from mrt_torch import inverse

        t = self.traffic

        def each(i, params, loss):
            self.step_ends.append(device.stamp(self.dev))
            if callback is not None:
                callback(i, params, loss)

        self.params, losses = inverse.optimize(
            self.apply, self.params, self.camera, self.width, self.height,
            self.target, steps=k, learning_rate=t["learning_rate"],
            spp=t["spp"], seed=self.next_seed, max_depth=t["max_depth"],
            optimizer=self.optimizer, callback=each)
        self.next_seed += k
        return losses

    def begin(self):
        """The state the next call starts from, cloned (a new optimizer
        may share the last one's tensors, which it updates in place)."""
        adam = {} if self.opt is None else self.opt.state_dict()["state"]
        return dict(seed=self.next_seed,
                    params=[p.clone() for p in self.params],
                    adam={j: {k: v.clone() for k, v in s.items()}
                          for j, s in adam.items()})

    def keeper(self, kept, n):
        """A callback that keeps in `kept` each leaf's first moment after
        a call's first step and the parameters after its n-th."""
        def keep(i, params, loss):
            if i == 0:
                state = [self.opt.state[p]
                         for p in self.opt.param_groups[0]["params"]]
                # An optimizer that kept no moment got no gradient.
                kept["exp_avg"] = [
                    s["exp_avg"].clone() if "exp_avg" in s else None
                    for s in state]
            if i == n - 1:
                kept["after"] = [p.clone() for p in params]
        return keep

    def call(self, k):
        """One call of k steps, keeping what the reference follows of its
        first check_steps (at most k)."""
        n = min(k, self.traffic["check_steps"])
        kept = self.begin()
        kept["losses"] = self.steps(k, self.keeper(kept, n))[:n]
        return kept

    def first_steps(self):
        """Set-up's first call, of check_steps steps; returns their
        seconds."""
        start = device.stamp(self.dev)
        self.first = self.call(self.traffic["check_steps"])
        return step_seconds(start, self.step_ends)


def step_seconds(start, ends):
    """Each step's seconds, from the mark before the first to the mark at
    each step's end."""
    marks = [start] + ends
    return [device.seconds_between(a, b) for a, b in zip(marks, marks[1:])]


def setup(cell, seed, dev):
    state = State(cell, seed, dev)
    times = state.first_steps()
    # A call of about a quarter of the window, from the later steps'
    # times (the first one builds and warms up).
    state.step_s = statistics.median(times[1:] or times)
    return state


def window(state, seconds):
    k = max(1, round(seconds / 4.0 / state.step_s))
    state.step_ends = []
    start = device.stamp(state.dev)

    def job(i):
        state.last = state.call(k)

    _, secs, _ = loop.closed_loop(job, seconds)
    times = step_seconds(start, state.step_ends)
    p90 = 1e3 * loop.quantile(times, 0.9)
    print(f"grad_step_ms_p90 {p90:.4f}: {loop.beyond(times, 0.9)} of "
          f"{len(times)} steps beyond it", file=sys.stderr)
    return dict(values=dict(grad_step_ms=1e3 * secs / len(times),
                            grad_step_ms_p90=p90),
                attempted=len(times), failed=0, job_seconds=times)


def parts():
    """A step's parts, timed in the traced run: the forward
    (render_image, l2_loss), backward() and the apply (Adam's step, then
    the next step's Scene.replace)."""
    from mrt_torch import inverse

    return (("grad forward", inverse, "render_image"),
            ("grad forward", inverse, "l2_loss"),
            ("grad backward", torch.Tensor, "backward"),
            ("grad apply", torch.optim.Adam, "step"),
            ("grad apply", State, "apply"))


# Host ranges of the profiled step, for its idle gaps.
RANGES = (("grad forward", "mrt_torch.inverse", "render_image"),
          ("grad loss", "mrt_torch.inverse", "l2_loss"),
          ("grad backward", "torch", "Tensor.backward"),
          ("grad adam", "torch.optim", "Adam.step"),
          ("grad apply", "mrt_torch.geometry.spheres", "Spheres.replace"))


def traced(state):
    """One step timed part by part, one timed whole, one profiled; the
    check follows the profiled one."""
    from torch.profiler import ProfilerActivity, profile

    timed = {}
    with trace.timed(state.dev, timed, parts()):
        state.steps(1)
    t0 = device.stamp(state.dev)
    state.steps(1)
    step_s = device.seconds_between(t0, device.stamp(state.dev))
    acts = [ProfilerActivity.CPU]
    if state.dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    tally = {}
    kept = state.begin()
    with trace.instrumented(tally, ranges=RANGES, taps={}), \
            profile(activities=acts) as prof:
        t0 = device.stamp(state.dev)
        kept["losses"] = state.steps(1, state.keeper(kept, 1))
        profiled_s = device.seconds_between(t0, device.stamp(state.dev))
    state.last = kept
    rec = trace.read(trace.events(prof), [r[0] for r in RANGES])
    record = dict(rec, step_s=step_s, parts_ms=timed, steps=1)
    return dict(record=record, busy_s=rec["busy_s"], window_s=profiled_s,
                breakdown=rec["breakdown"], attempted=3, failed=0)


def release(state):
    state.scene = state.camera = state.opt = None
    state.params = state.target = None
    if state.dev.type == "cuda":
        torch.cuda.empty_cache()


def followed(kept):
    """The program's side of a kept call: each step's loss, each leaf's
    first gradient as Adam got it (its first moment m1 = beta1 m0 +
    (1 - beta1) g, solved for g) and each leaf's change."""
    before = [kept["adam"].get(j, {}).get("exp_avg")
              for j in range(len(kept["params"]))]
    grads = [torch.zeros_like(p) if m1 is None else
             (m1 if m0 is None else m1 - BETA1 * m0) / (1.0 - BETA1)
             for p, m1, m0 in zip(kept["params"], kept["exp_avg"], before)]
    return dict(losses=kept["losses"], grads=grads,
                changes=[a - p for a, p in zip(kept["after"],
                                               kept["params"])])


def readings(port, ref):
    """The first step's relative loss gap, and by the worst leaf the gaps
    of the first gradient's and of the change's norms, each over the
    larger of the leaf's reference norm and the median leaf's.  A leaf
    whose reference gradient is under a thousandth of the median leaf's
    is left out (round-off moves it).  The later steps' losses are not
    compared: Adam's first steps move each parameter by about its
    learning rate whatever the size of its gradient, so a gradient that
    rounding alone makes differ moves its parameter as far as any, and
    the losses after it part by up to 5% on sound runs (PERF.md); each
    step's gap is printed beside them."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(port["losses"],
                                                ref["losses"])]
    g_ref = [float(g.double().norm()) for g in ref["grads"]]
    med = statistics.median(g_ref)
    counted = [i for i, g in enumerate(g_ref) if g >= 1e-3 * med]

    def gap(port, refs):
        p = [float(x.double().norm()) for x in port]
        r = [float(x.double().norm()) for x in refs]
        scale = statistics.median(r[i] for i in counted)
        return max(abs(p[i] - r[i]) / max(r[i], scale) for i in counted)

    print("loss gaps by step: " + ", ".join(f"{g:.3g}" for g in gaps),
          file=sys.stderr)
    return dict(loss_gap=gaps[0], grad_norm_gap=gap(port["grads"],
                                                    ref["grads"]),
                step_norm_gap=gap(port["changes"], ref["changes"]))


def numbers(ports, refs):
    """The numbers compared: set-up's first call's (first_loss_gap,
    grad_norm_gap, step_norm_gap) and the window's last call's, under
    ``window_``."""
    first, last = (readings(p, r) for p, r in zip(ports, refs))
    return dict(first_loss_gap=first["loss_gap"],
                grad_norm_gap=first["grad_norm_gap"],
                step_norm_gap=first["step_norm_gap"],
                window_loss_gap=last["loss_gap"],
                window_grad_norm_gap=last["grad_norm_gap"],
                window_step_norm_gap=last["step_norm_gap"])


def reference(state, dtype=torch.float32, fault=None):
    """The reference's steps from the start of each call the check
    follows, at the same render seeds."""
    c, t = state.config, state.traffic
    ref = scenes.build(c, state.dev, dtype, state.folders)
    args = (state.width, state.height, t["max_depth"], dtype, t["block"])
    target = gradient.target_image(ref, state.seed, *args)
    return [gradient.adam_steps(ref, kept["params"], target, kept["seed"],
                                len(kept["losses"]), t["learning_rate"],
                                state.width, state.height, t["max_depth"],
                                dtype, t["block"], fault=fault,
                                adam=kept["adam"])
            for kept in (state.first, state.last)]


def check(state):
    return numbers([followed(state.first), followed(state.last)],
                   reference(state))


# The readings' window (control.py): several calls, each handing its
# state to the next, before the check.
READING_WINDOW_S = 10.0


def _fresh(state, seed):
    fresh = setup(state.cell, seed, state.dev)
    window(fresh, READING_WINDOW_S)
    return fresh


def sound_reading(state, seed):
    """A fresh start from `seed`, a short window and the check."""
    return check(_fresh(state, seed))


def _as_program(state, seed, dtype, fault):
    fresh = _fresh(state, seed)
    return numbers(reference(fresh, dtype, fault), reference(fresh))


def control_reading(state, seed):
    """The reference in bfloat16 in the program's place, from the same
    two starts."""
    return _as_program(state, seed, torch.bfloat16, None)


def fault_readings(state, seed):
    """The faults a gradient step can have, planted in the reference put
    in the program's place: half of each step's pixels left out (the
    mean over the rest), and each image altered by 1% where it is made.
    A step that leaves its state unchanged reads 1 on step_norm_gap by
    its definition and needs no run."""
    return {fault: _as_program(state, seed, torch.float32, fault)
            for fault in ("half", "altered")}
