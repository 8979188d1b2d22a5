"""A whole run, the card's look skipped, at a tiny size on the CPU, in
each kind of cell with the number its real cell compares: sound,
``correct`` holds; with the timed path broken underneath it comes out
false (a token altered where it is produced, a decode step that leaves
the cache as it was, half of the batch's rows not computed); and with
the float8 control put in the program's place it comes out false. On
one card there is no exchange between chips to leave out."""
import pytest
import torch

from portbench import run
from portbench.lib import registry
from portbench.tests import tiny


def _run(tmp_path, cell, control=False):
    root = tiny.checkout(tmp_path)
    reg = registry.Registry.at(root, home=root)
    return run.run_cell(root, cell, 2 ** 33 + 1, 0.5, False, device="cpu",
                        t_start=0.0, reg=reg, control=control)


def _alter_token(monkeypatch):
    from repro_torch.models import model as M
    orig = M._next_token

    def bad(logits, greedy, gen):
        return (orig(logits, greedy, gen) + 1) % logits.shape[-1]
    monkeypatch.setattr(M, "_next_token", bad)


def _state_unchanged(monkeypatch):
    from repro_torch.models import attention as A
    monkeypatch.setattr(A, "_write_slot", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from repro_torch.models import model as M
    orig = M.decode_step

    def bad(params, token, caches, pos, cfg, active=None, adapter_ids=None):
        lg, caches = orig(params, token, caches, pos, cfg, active=active,
                          adapter_ids=adapter_ids)
        h = lg.shape[0] // 2
        lg = lg.clone()
        lg[h:] = lg[:lg.shape[0] - h]
        return lg, caches
    monkeypatch.setattr(M, "decode_step", bad)


FAULTS = {"token_altered": _alter_token, "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


CELLS = ["tiny-dense.chat", "tiny-moe.batch"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_the_control_is_not(tmp_path, cell):
    root = tiny.checkout(tmp_path)
    reg = registry.Registry.at(root, home=root)
    sound = run.run_cell(root, cell, 2 ** 33 + 1, 0.5, False, device="cpu",
                         t_start=0.0, reg=reg)
    assert sound["correct"], sound["checks"]
    assert list(sound)[-1] == "checks"
    # every served token placed at a step (the window's count is read)
    assert sound["notes"]["window_tokens"] is not None
    assert "serve_tok_s" in sound["metrics"]
    # the control in the program's place, judged by the same check
    ctl = run.run_cell(root, cell, 2 ** 33 + 1, 0.5, False, device="cpu",
                       t_start=0.0, reg=reg, control=True)
    assert not ctl["correct"], ctl["checks"]
    num = reg.cell(cell)["check"]["number"]
    assert ctl["checks"][num]["value"] == ctl["notes"]["control"][num]
    assert sound["notes"]["program"] == ctl["notes"]["program"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_faults_come_out_not_correct(tmp_path, monkeypatch, fault, cell):
    FAULTS[fault](monkeypatch)
    out = _run(tmp_path, cell)
    assert not out["correct"], out["checks"]


def test_tiny_cells_compare_their_real_cells_numbers(tmp_path):
    root = tiny.checkout(tmp_path)
    tiny_reg = registry.Registry.at(root, home=root)
    real = registry.Registry.at(run.ROOT)
    for name, real_name in (("tiny-dense.chat", "qwen2-7b.bank-chat"),
                            ("tiny-moe.batch",
                             "granite-moe-1b-a400m.bank-batch")):
        assert tiny_reg.cell(name)["check"]["number"] == \
            real.cell(real_name)["check"]["number"]


def test_moe_token_fault(tmp_path, monkeypatch):
    """The traced run judges the same way."""
    _alter_token(monkeypatch)
    root = tiny.checkout(tmp_path)
    reg = registry.Registry.at(root, home=root)
    out = run.run_cell(root, "tiny-moe.batch", 2 ** 33 + 1, 0.5, True,
                       device="cpu", t_start=0.0, reg=reg)
    assert not out["correct"], out["checks"]
