"""A run with the timed path broken underneath comes out not correct.

Each test drives the rest of a run (the tiny cell on the CPU: traffic,
cluster, window, the check), with one fault planted in the program's
model for the run: a token altered where the prompt pass or the decode
step produces it, a decode step that leaves its cache unchanged, and half
of the decode batch left out.  One chip has no exchange between chips to
leave out.  The sound run beside them comes out correct."""
import time

import pytest
import torch

import tiny
from harness import report

LIMIT = 0.25      # the sound tiny run reads 0 (test below); faults read > 1


def _run(kind="open", impl=None):
    cell = tiny.cell(kind, limit=LIMIT, impl=impl)
    return report.run_cell(cell, 5, 2.0, False, "cpu", time.perf_counter(),
                           registry=tiny.registry())


def _patch(monkeypatch, name, make):
    from repro_torch.models.model import Model
    monkeypatch.setattr(Model, name, make(getattr(Model, name)))


@pytest.mark.parametrize("kind,impl", [("open", "pallas"),
                                       ("closed", "paged")])
def test_sound_run_is_correct(kind, impl):
    res = _run(kind, impl)
    assert res["correct"], res["checks"]
    assert res["checks"]["logit_gap"]["value"] < LIMIT / 3


def test_decode_token_altered(monkeypatch):
    def make(fn):
        def decode(self, *a, **k):
            logits, caches = fn(self, *a, **k)
            return logits.roll(1, dims=-1), caches
        return decode
    _patch(monkeypatch, "decode", make)
    assert not _run()["correct"]


def test_prompt_token_altered(monkeypatch):
    def make(fn):
        def prefill(self, *a, **k):
            logits, caches = fn(self, *a, **k)
            return logits.roll(1, dims=-1), caches
        return prefill
    _patch(monkeypatch, "prefill_batched", make)
    _patch(monkeypatch, "prefill_resume", make)
    assert not _run()["correct"]


@pytest.mark.parametrize("kind,impl", [("open", "pallas"),
                                       ("closed", "paged")])
def test_decode_state_unchanged(monkeypatch, kind, impl):
    def make(fn):
        def decode(self, params, caches, *a, **k):
            logits, _ = fn(self, params, {n: t.clone()
                                          for n, t in caches.items()}, *a, **k)
            return logits, caches
        return decode
    _patch(monkeypatch, "decode", make)
    assert not _run(kind, impl)["correct"]


def test_half_the_decode_batch_left_out(monkeypatch):
    """The first half of the slots is left out: a decoder gives a request
    its lowest free slot, so the first half serves most requests, where the
    second stays empty under light load and a sampled request reached it
    only by timing."""
    def make(fn):
        def decode(self, params, caches, tokens, *a, **k):
            logits, caches = fn(self, params, caches, tokens, *a, **k)
            half = logits.shape[0] // 2
            return torch.cat([torch.zeros_like(logits[:half]),
                              logits[half:]]), caches
        return decode
    _patch(monkeypatch, "decode", make)
    assert not _run()["correct"]
