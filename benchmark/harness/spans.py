"""Spans recorded from outside the program: the traced run wraps, at run
time, the names that the program's callers look up, and records CUDA events
around each call. Nothing of the program is edited.

A target is ``package.module:function`` (the module attribute is replaced,
so callers that look it up there see the wrapper), ``package.module:Class.method``
(the class attribute), or ``object:attribute`` for an ``nn.Module`` that the
cell exposes under ``object`` (its ``forward``). A span can keep each call's
arguments for a reader (``capture``) while the device trace runs."""
from __future__ import annotations

import functools
import importlib

import torch


class Span:
    def __init__(self, target: str, capture: bool):
        self.target = target
        self.capture = capture
        self.events = []
        self.captures = []
        self.capturing = True

    def wrap(self, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            if self.capture and self.capturing:
                self.captures.append((args, kwargs))
            return out
        return timed

    def total_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


class Spans:
    """The spans of one traced run: ``install`` wraps every target and
    returns nothing; ``restore`` puts the originals back."""

    def __init__(self):
        self.spans: dict[str, Span] = {}
        self._undo = []

    def install(self, target: str, objects: dict, capture: bool = False) -> Span:
        if target in self.spans:
            self.spans[target].capture |= capture
            return self.spans[target]
        span = self.spans[target] = Span(target, capture)
        where, name = target.split(":")
        if where in objects:                      # an nn.Module's forward
            mod = getattr(objects[where], name)
            orig = mod.forward
            mod.forward = span.wrap(orig)
            self._undo.append(lambda: delattr(mod, "forward"))
            return span
        owner = importlib.import_module(where)
        attr = name
        if "." in name:
            cls, attr = name.split(".")
            owner = getattr(owner, cls)
        orig = getattr(owner, attr)
        setattr(owner, attr, span.wrap(orig))
        self._undo.append(lambda: setattr(owner, attr, orig))
        return span

    def stop_capture(self) -> None:
        """Keep no more arguments: the device trace has ended."""
        for span in self.spans.values():
            span.capturing = False

    def restore(self) -> None:
        while self._undo:
            self._undo.pop()()
