"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a tiny size, held to the tiny cells' limits (``tiny.py``). Each fault the cells can
have: serving, an answer for another frame (the previous one) and a
detection's class altered where it is made; training, a step that returns
its state unchanged and half of each batch left out (the mean over the
rest). One card, so no exchange between chips to leave out."""

import pytest
import torch

from perfbench import run
from perfbench.kinds import serve_stream, train_steps
from perfbench.tests import tiny

ARGS = ["--seed", "2147483651", "--seconds", "1", "--trace", "0"]


@pytest.fixture
def root(tmp_path):
    return tiny.make_root(tmp_path)


def _run(root, cell):
    return run.run(["--workload", cell] + ARGS, device="cpu", root=root)


@pytest.mark.parametrize("fault", serve_stream.FAULTS)
def test_serving_fault_is_not_correct(root, monkeypatch, fault):
    build = serve_stream.build_backend
    monkeypatch.setattr(serve_stream, "build_backend",
                        lambda *a: serve_stream.Faulty(build(*a), fault))
    out = _run(root, "tiny_serve")
    assert out["correct"] is False, out["check"]


def test_serving_sound_run_is_correct(root):
    out = _run(root, "tiny_serve")
    assert out["correct"] is True, out["check"]


def _unchanged(step):
    def frozen(state, batch, **kw):
        keep = [{k: v.clone() for k, v in m.state_dict().items()} for m in (state.model, state.ema)]
        out = step(state, batch, **kw)
        for m, sd in zip((state.model, state.ema), keep):
            m.load_state_dict(sd)
        return out
    return frozen


def test_step_returning_its_state_unchanged_is_not_correct(root, monkeypatch):
    make = train_steps.program_state

    def program_state(*a):
        state, step = make(*a)
        return state, _unchanged(step)

    monkeypatch.setattr(train_steps, "program_state", program_state)
    out = _run(root, "tiny_train")
    assert out["correct"] is False and out["check"]["change_gap_median"]["value"] > 0.5, out["check"]


def test_half_batch_is_not_correct(root, monkeypatch):
    call = train_steps.call
    monkeypatch.setattr(train_steps, "call", lambda step, state, b: call(step, state,
                                                                       train_steps.half(b)))
    out = _run(root, "tiny_train")
    assert out["correct"] is False, out["check"]


def test_training_sound_run_is_correct(root):
    out = _run(root, "tiny_train")
    assert out["correct"] is True, out["check"]
    assert torch.isfinite(torch.tensor([c["value"] for c in out["check"].values()])).all()
