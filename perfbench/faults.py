"""What the check must refuse, put in the program's place through
``harness.run_cell(wrap=...)``:

- ``control``: the reference filter step itself in the program's place,
  computed in the precision below the configuration's float32, TF32
  products (the step that would tempt a later change);
- ``stale``: a step that returns its state unchanged;
- ``half``: half of the banks left out, the rest standing in for them (the
  second half given the first half's readouts and kept as they were);
- ``altered``: an answer altered where it is produced (every bank's class
  probabilities reversed).

Each fault wraps the call that the mode hands to ``wrap``: the program's
bank step, or its scan over a chunk of frames.  The benchmark's runs never
use these; ``control.py`` reads them on the card and
``tests/test_perfbench_faults.py`` on the CPU.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import torch

from .reference import gp as ref_gp
from .reference import pf as ref_pf

KINDS = ("control", "stale", "half", "altered")


def _outputs(probs, mean):
    return SimpleNamespace(class_probs=probs, most_likely_class=torch.argmax(probs, dim=-1),
                           state_mean=mean)


def filter_control(cfg, asset, T, device):
    """The reference filter step at TF32, on the configuration's posterior,
    with the program's step's signature: (state, z, noise) -> (state,
    readouts)."""
    post = ref_gp.posterior(asset, device, "tf32", cfg)
    Tm = torch.as_tensor(T, device=device)

    def step(state, z, noise):
        x, c, probs, mean = ref_pf.step(post, state.x, state.c, z, noise.u_trans,
                                        noise.eps_dyn, noise.u_res, Tm)
        return SimpleNamespace(x=x, c=c), _outputs(probs, mean)

    return step


def _fields(obj, fn, by_name: bool = False):
    """The same state or draws with ``fn`` applied to every field;
    ``by_name`` passes the field's name too."""
    fields = ([f.name for f in dataclasses.fields(obj)] if dataclasses.is_dataclass(obj)
              else list(vars(obj)))
    vals = {f: (fn(getattr(obj, f), f) if by_name else fn(getattr(obj, f))) for f in fields}
    return type(obj)(**vals)


def _scan_of(step):
    """A scan over frames (Z (B, T, D), noise with a leading frame axis)
    from a step."""
    def scan(state, Z, noise):
        outs = []
        for t in range(Z.shape[1]):
            state, out = step(state, Z[:, t], _fields(noise, lambda a: a[t]))
            outs.append(out)
        return state, _outputs(torch.stack([o.class_probs for o in outs], dim=1),
                               torch.stack([o.state_mean for o in outs], dim=1))
    return scan


def filter_wrap(kind: str, cfg, asset, T, device):
    """``wrap(call, fn)`` for ``run_cell`` on a filter cell: ``fn`` is the
    program's bank step (``call`` 'step') or scan ('scan'), and comes back
    broken; the bank's initialisation ('init') is left as it is.  A step's
    draws have the bank axis first, a scan's second (after the frame)."""
    def stale(fn, call):
        if call == "step":
            return lambda s, z, n: (s, fn(s, z, n)[1])

        def scan(s, Z, n):
            # every frame from the chunk's first state, which never moves
            outs = [fn(s, Z[:, t:t + 1], _fields(n, lambda a: a[t:t + 1]))[1]
                    for t in range(Z.shape[1])]
            return s, _outputs(torch.cat([o.class_probs for o in outs], dim=1),
                               torch.cat([o.state_mean for o in outs], dim=1))
        return scan

    def half(fn, call):
        axis = 0 if call == "step" else 1

        def run(s, z, n):
            B = s.x.shape[0]
            h = B // 2
            new, out = fn(_fields(s, lambda a: a[:h]), z[:h],
                          _fields(n, lambda a: a.narrow(axis, 0, h).contiguous()))
            state = _fields(s, lambda a, f: torch.cat([getattr(new, f), a[h:]]), by_name=True)
            mirror = torch.arange(B, device=z.device) % h
            return state, _outputs(out.class_probs[mirror], out.state_mean[mirror])
        return run

    def altered(fn, call):
        def run(s, z, n):
            new, out = fn(s, z, n)
            return new, _outputs(out.class_probs.flip(-1), out.state_mean)
        return run

    def wrap(call, fn):
        if call == "init":
            return fn
        if kind == "control":
            step = filter_control(cfg, asset, T, device)
            return step if call == "step" else _scan_of(step)
        return {"stale": stale, "half": half, "altered": altered}[kind](fn, call)

    return wrap
