"""The port's training runtime around the step, on the CPU: ``StepMonitor``
against JAX's on the same scripts, the loop's deferred metric fetch, its
NaN sentinel, preemption and resume, ``eval_fn``, the launcher's
``--ckpt-dir`` resume, and the zipf corpus (whose draws are torch's, so it
is held by its statistics, not by JAX's values)."""
import math
import signal
import threading

import jax
import numpy as np
import pytest
import torch

from repro.data import synthetic as jax_synthetic
from repro.train.monitor import StepMonitor as JaxStepMonitor
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core import make_optimizer
from repro_torch.core.schedules import cosine_with_warmup
from repro_torch.data.synthetic import ZIPF_BUCKETS, SyntheticDataConfig, SyntheticDataset
from repro_torch.models import build_model
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import loop as loop_lib
from repro_torch.train.loop import train_loop
from repro_torch.train.monitor import StepMonitor
from repro_torch.train.state import TrainState
from repro_torch.train.step import make_train_step

# One intra-op thread: the test workers share the host's cores, and the
# port's results do not depend on the thread count (core/svd.py).
torch.set_num_threads(1)

NAN = float("nan")


# ---------------------------------------------------------------------------
# StepMonitor: the same script through both packages' monitors
# ---------------------------------------------------------------------------


def _play(monitor_cls, script, **kw):
    """Run ``script`` ((op, step, arg) tuples) on a monitor with a fake
    clock; returns every op's result (or the exception's type and step)
    and the final counters."""
    t = [0.0]
    mon = monitor_cls(clock=lambda: t[0], **kw)
    out = []
    for op, step, arg in script:
        try:
            if op == "step":  # a step of ``arg`` seconds, no loss
                mon.start_step()
                t[0] += arg
                out.append(mon.end_step(step))
            elif op == "step_loss":  # a 1 s step reporting loss ``arg``
                mon.start_step()
                t[0] += 1.0
                out.append(mon.end_step(step, loss=arg))
            elif op == "flag":
                out.append(mon.note_loss(step, arg, raise_on_streak=False))
            else:
                out.append(mon.note_loss(step, arg))
        except FloatingPointError:
            out.append(("FloatingPointError", step))
            break
    return out, mon.stragglers, mon.bad_loss_count, mon.step_count, mon.counters()


SCRIPTS = {
    # ten 1 s steps, then one of 10 s: the straggler window flags it
    "straggler_window": ([("step", i, 1.0) for i in range(10)] + [("step", 10, 10.0)]
                         + [("step", 11, 1.0), ("step", 12, 2.9), ("step", 13, 3.1)], {}),
    # a window of 3 forgets the slow steps
    "short_window": ([("step", i, 1.0 + i) for i in range(8)] + [("step", 8, 30.0)],
                     dict(window=3)),
    # three non-finite losses in a row with max_bad_losses=2: aborts at the third
    "nan_sentinel_aborts": ([("step_loss", 0, NAN), ("step_loss", 1, math.inf),
                             ("step_loss", 2, NAN), ("step_loss", 3, 1.0)],
                            dict(max_bad_losses=2)),
    # alternating losses never trip it: a finite loss resets the count
    "counter_resets": ([("step_loss", i, NAN if i % 2 == 0 else 1.0) for i in range(10)],
                       dict(max_bad_losses=2)),
    # deferred losses (note_loss) keep the same counts as per-step ones
    "deferred_note_loss": ([("step", i, 1.0) for i in range(4)]
                           + [("note", i, NAN) for i in range(4)], dict(max_bad_losses=3)),
    # flag mode reports the streak instead of raising, and recovers
    "flag_mode": ([("flag", 0, NAN), ("flag", 1, NAN), ("flag", 2, NAN), ("flag", 3, 1.0),
                   ("flag", 4, NAN)], dict(max_bad_losses=2)),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_step_monitor_matches_jax(name):
    script, kw = SCRIPTS[name]
    got = _play(StepMonitor, script, **kw)
    assert got == _play(JaxStepMonitor, script, **kw)
    if name == "straggler_window":
        assert got[1] == [10, 13]  # 10x and 3.1x the median; 2.9x is not
    if name == "nan_sentinel_aborts":
        assert got[0][-1] == ("FloatingPointError", 2)
    if name == "flag_mode":
        assert got[0] == [False, False, True, False, False]


# ---------------------------------------------------------------------------
# the loop with stand-in steps
# ---------------------------------------------------------------------------


class _ProbeLoss:
    """Records at which loop step its value is fetched."""

    def __init__(self, value, step, log, now):
        self.value, self.step, self._log, self._now = value, step, log, now

    def __float__(self):
        self._log.append((self.step, self._now[0] - 1))
        return self.value


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("llama3-8b", smoke=True).with_(dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    data = SyntheticDataset(SyntheticDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                                global_batch=2), device="cpu")
    return model, params, data


def _opt(params, steps, tau=10, **kw):
    return make_optimizer("galore-sara-adam", params, rank=8, tau=tau, grad_clip_norm=1.0,
                          svd_backend="randomized", engine="bucketed",
                          lr_schedule=cosine_with_warmup(0.01, 1, steps), **kw)


def test_loop_fetches_metrics_at_flush_points(smoke, tmp_path):
    """Losses are fetched in batches at log / refresh / checkpoint / final
    steps, not once per step, and come out as a per-step fetch gives them."""
    model, params, data = smoke
    total, log_every = 12, 5
    opt = _opt(params, total)  # tau 10
    tc = TrainConfig(total_steps=total, checkpoint_every=0, checkpoint_dir=str(tmp_path / "c"))
    fetched, now = [], [0]

    def fake_step(state, batch, group=0):
        m = {"loss": _ProbeLoss(1.0 + now[0], now[0], fetched, now)}
        now[0] += 1
        return TrainState(state.params, state.opt_state._replace(step=state.opt_state.step + 1)), m

    res = train_loop(model, opt, data, tc, {"step": fake_step, "refresh_step": fake_step},
                     state=TrainState(params, opt.init(params)), log_every=log_every,
                     handle_signals=False)
    assert res.losses == [1.0 + s for s in range(total)]
    assert [r["step"] for r in res.history] == [0.0, 5.0, 10.0, 11.0]
    assert [r["loss"] for r in res.history] == [1.0, 6.0, 11.0, 12.0]
    assert len(fetched) == total
    for step, at in fetched:
        assert step <= at and (at % log_every == 0 or at % 10 == 0 or at == total - 1)
    assert sum(1 for s, at in fetched if at > s) >= total // 2


def test_deferred_fetch_gives_the_per_step_losses_and_history(smoke, tmp_path):
    model, params, data = smoke
    total = 6
    runs = {}
    for log_every in (1, 4):  # 1: every step fetched at once
        opt = _opt(params, total, tau=3)
        tc = TrainConfig(total_steps=total, checkpoint_every=0,
                         checkpoint_dir=str(tmp_path / f"l{log_every}"))
        runs[log_every] = train_loop(model, opt, data, tc, make_train_step(model, opt),
                                     log_every=log_every, handle_signals=False)
    per_step, deferred = runs[1], runs[4]
    assert deferred.losses == per_step.losses
    assert [r["step"] for r in deferred.history] == [0.0, 4.0, 5.0]
    by_step = {r["step"]: r for r in per_step.history}
    keys = ("loss", "grad_norm", "update_norm", "skipped", "skip_steps", "rollbacks",
            "save_retries", "save_failures")
    for r in deferred.history:
        assert {k: r[k] for k in keys} == {k: by_step[r["step"]][k] for k in keys}
        assert {"step_time_s", "median_step_time_s", "straggler"} <= set(r)


def test_loop_nan_sentinel_aborts_at_the_fetch(smoke, tmp_path):
    model, params, data = smoke
    opt = _opt(params, 30)
    tc = TrainConfig(total_steps=30, checkpoint_every=0, checkpoint_dir=str(tmp_path / "n"))
    calls = []

    def nan_step(state, batch, group=0):
        calls.append(1)
        return state, {"loss": torch.tensor(NAN)}

    with pytest.raises(FloatingPointError):
        train_loop(model, opt, data, tc, {"step": nan_step, "refresh_step": nan_step},
                   state=TrainState(params, opt.init(params)), log_every=3,
                   handle_signals=False)
    # more than five bad losses in a row: it raised at the step-6 flush
    assert len(calls) == 7


def test_eval_fn_and_batch_hook(smoke, tmp_path):
    model, params, data = smoke
    opt = _opt(params, 3)
    tc = TrainConfig(total_steps=3, checkpoint_every=0, checkpoint_dir=str(tmp_path / "e"))
    seen = []

    def hook(batch):
        seen.append(batch["tokens"].clone())
        return {k: v.flip(0) for k, v in batch.items()}

    res = train_loop(model, opt, data, tc, make_train_step(model, opt), log_every=2,
                     handle_signals=False, batch_hook=hook,
                     eval_fn=lambda st, s: {"eval_step": float(st.step), "at": float(s)})
    assert len(seen) == 3 and torch.equal(seen[1], data.batch_at(1)["tokens"])
    assert [(r["step"], r["eval_step"], r["at"]) for r in res.history] == [
        (0.0, 1.0, 0.0), (2.0, 3.0, 2.0)]


# ---------------------------------------------------------------------------
# preemption and resume
# ---------------------------------------------------------------------------


def test_preemption_saves_at_the_next_step_and_a_rerun_resumes(smoke, tmp_path, monkeypatch):
    model, params, data = smoke
    total = 6
    opt = _opt(params, total, tau=2)  # refreshes at 0, 2, 4

    def run(d, **kw):
        tc = TrainConfig(total_steps=total, checkpoint_every=4, checkpoint_dir=str(d),
                         async_checkpoint=False)
        return train_loop(model, opt, data, tc, make_train_step(model, opt), log_every=1, **kw)

    clean = run(tmp_path / "clean", handle_signals=False)
    guards = []

    class RecordingGuard(loop_lib._PreemptionGuard):
        def __init__(self, enable):
            super().__init__(enable)
            guards.append(self)

    monkeypatch.setattr(loop_lib, "_PreemptionGuard", RecordingGuard)
    before = signal.getsignal(signal.SIGTERM)
    batches = []

    def preempt_at_step_2(batch):
        batches.append(1)
        if len(batches) == 3:  # step 2's batch: the signal arrives mid-step
            guards[-1]._handler(signal.SIGTERM, None)
            if threading.current_thread() is threading.main_thread():
                assert signal.getsignal(signal.SIGTERM) == guards[-1]._handler
        return batch

    first = run(tmp_path / "pre", batch_hook=preempt_at_step_2)
    assert first.final_step == 3 and len(first.losses) == 3
    assert ckpt.checkpoint_dirs(str(tmp_path / "pre")) == [3]
    assert signal.getsignal(signal.SIGTERM) == before  # the guard restored it
    rest = run(tmp_path / "pre", handle_signals=False)
    assert rest.checkpoints.last_load["step"] == 3 and rest.final_step == total
    assert first.losses + rest.losses == clean.losses
    assert ckpt.checkpoint_dirs(str(tmp_path / "pre")) == [3, 4]


def test_loop_says_where_it_resumed_and_what_it_skipped(smoke, tmp_path, capsys):
    """Every restore is printed by the loop itself, with the newer
    checkpoints it walked past."""
    model, params, data = smoke
    opt = _opt(params, 6)
    d = tmp_path / "say"

    def run(total):
        tc = TrainConfig(total_steps=total, checkpoint_every=2, checkpoint_dir=str(d),
                         async_checkpoint=False)
        return train_loop(model, opt, data, tc, make_train_step(model, opt), log_every=1,
                          handle_signals=False)

    run(4)
    assert "resumed" not in capsys.readouterr().out
    cdir = d / "step_00000004"
    victim = sorted(f for f in cdir.iterdir() if f.suffix == ".npy")[0]
    with open(victim, "r+b") as f:
        f.seek(100)
        f.write(b"\xde\xad\xbe\xef")
    res = run(6)
    out = capsys.readouterr().out
    assert f"[train] resumed from {d} at step 2; skipped step 4: " in out
    assert "checksum mismatch" in out and res.final_step == 6 and len(res.losses) == 4


def test_launcher_ckpt_dir_resumes(tmp_path, capsys):
    from repro_torch.launch import train as launch_train

    argv = ["--smoke", "--device", "cpu", "--tau", "2", "--rank", "8", "--seq", "16",
            "--batch", "2", "--engine", "bucketed", "--svd-backend", "randomized",
            "--dist", "zipf", "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    launch_train.main(argv + ["--steps", "4"])
    out = capsys.readouterr().out
    assert "resumed" not in out and "[train] done: step 4" in out
    launch_train.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out
    assert f"[train] resumed from {tmp_path / 'ck'} at step 4" in out
    assert "[train] done: step 6" in out
    assert ckpt.checkpoint_dirs(str(tmp_path / "ck")) == [2, 4, 6]


# ---------------------------------------------------------------------------
# the zipf corpus
# ---------------------------------------------------------------------------


def _zipf(**kw):
    cfg = dict(vocab_size=128, seq_len=32, global_batch=4, dist="zipf")
    cfg.update(kw)
    return SyntheticDataset(SyntheticDataConfig(**cfg), device="cpu")


def test_zipf_is_seekable_and_deterministic():
    d1, d2 = _zipf(), _zipf()
    b1, b2 = d1.batch_at(17), d2.batch_at(17)
    assert torch.equal(b1["tokens"], b2["tokens"]) and b1["tokens"].dtype == torch.int32
    assert not torch.equal(b1["tokens"], d1.batch_at(18)["tokens"])
    it = d1.iter(17)
    assert torch.equal(next(it)["tokens"], b1["tokens"])
    assert torch.equal(next(it)["tokens"], d1.batch_at(18)["tokens"])
    assert not torch.equal(_zipf(seed=1).batch_at(17)["tokens"], b1["tokens"])


def test_zipf_labels_are_shifted_tokens():
    b = _zipf(seq_len=16, global_batch=2).batch_at(0)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all()


def test_zipf_low_token_ids_dominate():
    toks = _zipf().batch_at(3)["tokens"].numpy()
    assert toks.shape == (4, 32)
    assert (toks < 32).mean() > 0.5


def test_zipf_positional_drift():
    """A token's frequency depends on its position's bucket: each bucket's
    empirical distribution is nearer its own expected one (the unigram
    logits plus that bucket's drift) than another bucket's."""
    v, s, b = 64, ZIPF_BUCKETS, 4096  # one position per bucket
    data = _zipf(vocab_size=v, seq_len=s, global_batch=b)
    toks = data.batch_at(0)["tokens"].numpy()
    probs = torch.softmax(data._logits[None] + data._drift, dim=-1).numpy()  # (64, v)
    emp = np.stack([np.bincount(toks[:, p], minlength=v) / b for p in range(s)])
    own = np.abs(emp - probs).sum(1)
    other = np.abs(emp - np.roll(probs, 1, axis=0)).sum(1)
    assert (own < other).mean() > 0.9
    # and the drift is not noise: two buckets' expected distributions differ
    assert np.abs(probs[0] - probs[-1]).sum() > 0.3


def _zipf_pair(vocab_size, seq_len, global_batch=2):
    """JAX's zipf dataset and the port's at the same config, the port's
    drift replaced by JAX's (the two draw it from different generators)."""
    cfg = dict(vocab_size=vocab_size, seq_len=seq_len, global_batch=global_batch, dist="zipf")
    jds = jax_synthetic.SyntheticDataset(jax_synthetic.SyntheticDataConfig(**cfg))
    port = _zipf(**cfg)
    port._drift = torch.from_numpy(np.array(jds._drift))
    return jds, port


def _jax_zipf_table(jds, monkeypatch):
    """(S, V) f64: the distribution JAX's ``_sample_batch`` draws each
    position from, the softmax of the logits it hands ``categorical``."""
    seen = []
    categorical = jax.random.categorical

    def capture(key, logits, axis=-1, **kw):
        seen.append(np.asarray(logits))
        return categorical(key, logits, axis=axis, **kw)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jds._sample_batch(jax.random.PRNGKey(0))
    monkeypatch.undo()
    assert len(seen) == 1 and seen[0].shape == (jds.cfg.seq_len, jds.cfg.vocab_size)
    return np.asarray(jax.nn.softmax(seen[0], axis=-1), dtype=np.float64)


@pytest.mark.parametrize("vocab_size", [64, 128256])
def test_zipf_logits_match_jax(vocab_size):
    """-1.1 log(rank): to 2 f32 ulp (torch's log and XLA's differ in the
    last bits: 1 ulp measured at vocab 64, 2 at 128256)."""
    jds, port = _zipf_pair(vocab_size, 16)
    np.testing.assert_allclose(port._logits.numpy(), np.asarray(jds._logits), rtol=2.5e-7, atol=0)
    assert port._logits.dtype == torch.float32 and port._drift.shape == (ZIPF_BUCKETS, vocab_size)


@pytest.mark.parametrize("vocab_size,seq_len", [(64, 100), (64, 512), (64, 37), (128256, 100)])
def test_zipf_position_table_matches_jax(vocab_size, seq_len, monkeypatch):
    """Each position's distribution, bucket mapping p * 64 // S included,
    equals JAX's at sequence lengths where buckets hold 0, 1, 2 or 8
    positions: relative 1e-5 per entry (the logits' ulps through exp;
    measured 1.2e-6 at vocab 64, 4.0e-6 at 128256)."""
    jds, port = _zipf_pair(vocab_size, seq_len)
    np.testing.assert_allclose(port._position_probs().double().numpy(),
                               _jax_zipf_table(jds, monkeypatch), rtol=1e-5, atol=0)


def _chi2_z(counts, table, n):
    """z-score of the summed per-position chi-square of ``counts`` (S, V),
    n draws per position, under ``table``: its exact multinomial mean
    S (V - 1) and variance sum_p 2 (V - 1) + (sum_i 1/p_i - V^2 - 2V + 2) / n."""
    s, v = table.shape
    chi2 = ((counts - n * table) ** 2 / (n * table)).sum()
    var = (2 * (v - 1) * s + ((1 / table).sum(1) - v * v - 2 * v + 2).sum() / n)
    return (chi2 - s * (v - 1)) / math.sqrt(var)


@pytest.mark.parametrize("seq_len", [100, 512])
def test_zipf_draws_follow_jax_table(seq_len, monkeypatch):
    """The port's tokens, drawn with JAX's drift, have JAX's per-position
    frequencies: the summed chi-square is within 5 standard deviations of
    its mean (measured |z| <= 1.5), while the table of the neighbouring
    bucket, or JAX's with the drift scaled by 0.9, is rejected."""
    v, n = 64, 8192
    jds, port = _zipf_pair(v, seq_len, global_batch=n)
    table = _jax_zipf_table(jds, monkeypatch)
    toks = port.batch_at(5)["tokens"].numpy()
    counts = np.stack([np.bincount(toks[:, p], minlength=v) for p in range(seq_len)])
    assert abs(_chi2_z(counts, table, n)) < 5
    # the test's power: a bucket off, or a drift 10% small, is far outside
    neighbour = np.roll(table, -(-seq_len // ZIPF_BUCKETS), axis=0)
    assert _chi2_z(counts, neighbour, n) > 100
    bucket = np.arange(seq_len) * ZIPF_BUCKETS // seq_len
    small = np.asarray(jds._logits)[None] + 0.9 * np.asarray(jds._drift)[bucket]
    small = np.exp(small - small.max(1, keepdims=True))
    assert _chi2_z(counts, small / small.sum(1, keepdims=True), n) > 5


def test_bigram_entropy_and_unknown_dist():
    cfg = SyntheticDataConfig(vocab_size=256, seq_len=8, global_batch=2)
    assert SyntheticDataset(cfg, device="cpu").bigram_entropy() < 0.7 * np.log(256)
    with pytest.raises(ValueError):
        _zipf().bigram_entropy()
    with pytest.raises(ValueError):
        _zipf(dist="uniform")
