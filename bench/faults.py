"""Faults planted underneath a run, to show that the comparison catches
them (``bench/control.py`` on the card, ``bench/tests`` on the CPU). Each
is a context manager that patches the program for its duration.

- ``unchanged``: the reconstruction step leaves its states as they were
  (Adam's update does nothing);
- ``half_batch``: the step's loss is the mean over the first half of each
  minibatch, the rest left out;
- ``altered_export``: one site of every exported block has its codes
  altered where the export makes them;
- ``altered_token``: the serving engine alters every seventh token it
  emits from a decode step.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name, value):
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def unchanged():
    from repro_torch.core import reconstruct
    return _patched(reconstruct, "adam_update_", lambda *a, **k: None)


@contextlib.contextmanager
def half_batch():
    from repro_torch.core.reconstruct import _Engine
    orig_init, orig_mb = _Engine.__init__, _Engine._minibatch

    def init(self, *a, **k):
        orig_init(self, *a, **k)
        self.count //= 2

    def minibatch(self, ix):
        xb, yb, wb = orig_mb(self, ix)
        h = xb.shape[0] // 2
        return xb[:h], yb[:h], None if wb is None else wb[:h]

    with _patched(_Engine, "__init__", init), \
            _patched(_Engine, "_minibatch", minibatch):
        yield


def altered_export():
    from repro_torch.core import reconstruct
    orig = reconstruct.finalize_block

    def finalize(block, recipe, wstates, as_qtensor=True):
        out = orig(block, recipe, wstates, as_qtensor=as_qtensor)
        qt = out["attn"]["wo"]
        qt.codes.bitwise_xor_(1)  # the low code of every byte, one step
        return out
    return _patched(reconstruct, "finalize_block", finalize)


def altered_token():
    from repro_torch.serve.engine import ServeEngine
    orig = ServeEngine.step

    def step(self):
        pairs = orig(self)
        out = []
        for j, (rid, tok) in enumerate(pairs):
            if (self.decode_steps + j) % 7 == 0:
                tok = (tok + 1) % self.model.cfg.vocab
                held = [s.emitted for s in self.slots if s.rid == rid]
                held += [toks for r, toks in self._finished if r == rid]
                for toks in held:
                    toks[-1] = tok
            out.append((rid, tok))
        return out
    return _patched(ServeEngine, "step", step)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "altered_export": altered_export, "altered_token": altered_token}
