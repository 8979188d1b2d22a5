"""The tail and rate arithmetic on synthetic completions."""
from portbench.lib import emission, flops, readers


def _reqs(stall_at=None, stall=0.0):
    """40 requests due every 0.25 s, each admitted at once, its first
    token 0.1 s after admission and 20 more tokens 0.05 s apart; a stall
    delays every request due before its end to the stall's end."""
    out = []
    for i in range(40):
        due = 0.25 * i
        admit = due
        if stall_at is not None and stall_at <= due < stall_at + stall:
            admit = stall_at + stall        # waits the stall out
        first = admit + 0.1
        out.append({"due": due, "admit": admit, "first": first,
                    "done": first + 20 * 0.05, "n_out": 21, "prompt": 100})
    return out


def test_ttft_counts_from_due_and_moves_with_a_stall():
    base = readers.p95(readers.ttft_s({"requests": _reqs()}))
    assert abs(base - 0.1) < 1e-12
    stalled = readers.p95(readers.ttft_s({"requests": _reqs(2.0, 3.0)}))
    assert stalled > 2.0                   # the wait behind the stall counts
    q = readers.p95(readers.queue_s({"requests": _reqs(2.0, 3.0)}))
    assert q > 1.9


def test_tpot():
    v = readers.p95(readers.tpot_ms({"requests": _reqs()}))
    assert abs(v - 50.0) < 1e-9


def test_window_mfu_is_work_over_time():
    obs = {"window_flops": 4e15, "window": (0.0, 2.0)}
    assert abs(readers.window_mfu(obs) - 100 * 2e15 / 989e12) < 1e-12
    assert readers.window_mfu({**obs, "window": (0.0, 4.0)}) < \
        readers.window_mfu(obs)
    assert readers.window_mfu({**obs, "window_flops": None}) is None


def test_flops_by_token_sum():
    sz = {"n_layers": 3, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
          "head_dim": 16, "d_ff": 128, "vocab_size": 256, "n_prefix": 4,
          "lora_rank": 4, "lora_targets": ["q", "v"]}
    P, n = 10, 6
    pre = sum(flops.token_flops(sz, p + 1 + 4, False) for p in range(P)) \
        + 2 * 64 * 256
    assert abs(flops.prefill_flops(sz, P) - pre) < 1e-6
    dec = sum(flops.token_flops(sz, P + j + 1 + 4, True)
              for j in range(n - 1))
    assert abs(flops.decode_flops(sz, P, n) - dec) < 1e-6


def _segs():
    """Three segments of 4, 2 and 8 steps, launched at 10, 20 and 30 s,
    each step 1 s after the last."""
    return [{"t": t, "steps": n, "step_t": [t + 0.5 + j for j in range(n)]}
            for t, n in ((10.0, 4), (20.0, 2), (30.0, 8))]


def test_tokens_are_placed_at_their_steps():
    # live from the first segment with 5 tokens: 4 in it, 1 in the next;
    # live from the second with 9: 2, then 7 of the third's 8 steps
    recs = [{"first": 14.2, "done": 22.1, "n_out": 5},
            {"first": 22.1, "done": 38.3, "n_out": 9}]
    t = emission.token_times(recs, _segs())
    assert list(t[0]) == [10.5, 11.5, 12.5, 13.5, 20.5]
    assert list(t[1]) == [20.5, 21.5] + [30.5 + j for j in range(7)]
    assert emission.in_window(t, 12.0, 31.0) == 3 + 2 + 1
    # a segment whose steps were not each seen gives no times at all
    segs = _segs()
    segs[2]["step_t"].pop()
    assert emission.token_times(recs, segs) is None


def test_records_that_do_not_add_up_give_no_times():
    # 3 tokens cannot span two segments that run 4 and 2 steps
    assert emission.token_times(
        [{"first": 14.0, "done": 22.0, "n_out": 3}], _segs()) is None
    # more tokens than the segments it was live in ran
    assert emission.token_times(
        [{"first": 14.0, "done": 14.5, "n_out": 6}], _segs()) is None
    # finished before any segment
    assert emission.token_times(
        [{"first": 5.0, "done": 6.0, "n_out": 1}], _segs()) is None


def test_rate_counts_every_token_in_the_window_over_its_length():
    obs = {"window_tokens": 600, "window": (10.0, 40.0)}
    assert readers.window_tok_s(obs) == 20.0
    assert readers.window_tok_s({**obs, "window_tokens": None}) is None
