"""The PyTorch port's live resharding under churn against the JAX
package's (tests/test_torch_reshard.py's World: both routers, the same
map states, tuples and breaker clock): a delta publish landing mid-window
and dual-applied, and a shrink under churn, each streamed to its cutover
(about 260 steps of 4 KB).  Every step's result is compared; both
routers' verdicts, counters and telemetry are compared with each other
and with the host oracle after the first step, after every
CHECK_EVERY-th step and the last, and after the cutover (a check is two
dispatches on the CPU mesh, most of the stream's time).  Kept apart from
tests/test_torch_reshard.py so that `--dist loadfile` runs these two
long streams on another worker.  Every value is an integer: every
comparison is exact.
"""

from test_torch_reshard import (  # noqa: F401 (_disarm: an autouse fixture)
    World,
    _disarm,
    _need_jax,
    _same_stats,
    _same_step,
    _stream,
)

CHECK_EVERY = 4


def test_churn_during_migration_delta_dual_applied():
    _need_jax()
    w = World(seed=17)
    jp, tp_ = w.plans(4, step_bytes=1 << 12)
    jp.begin()
    tp_.begin()
    _same_step(tp_.step(), jp.step(), "churn step 0")
    w.check("churn mid 1")
    w.add_rule(0, 65536, 5001)
    jt, tt = w.compile()
    assert w.publish(jt, tt, delta="current").mode == "delta"
    jp.on_publish(jt)
    tp_.on_publish(tt)
    w.want = w.oracle()
    w.check("churn mid 2")
    _stream(w, jp, tp_, "churn drain", CHECK_EVERY)
    out, jout = tp_.cutover(), jp.cutover()
    _same_stats(out, jout, "churn")
    assert out["outcome"] == "cutover" and out["restarts"] == 0
    w.check("churn post-cutover")
    w.publish(*w.compile())
    w.check("churn post-cutover publish")


def test_shrink_under_churn():
    _need_jax()
    w = World(dp=2, tp=4, seed=23)
    w.check("pre-shrink")
    jp, tp_ = w.plans(2, step_bytes=1 << 12)
    jp.begin()
    tp_.begin()
    _same_step(tp_.step(), jp.step(), "shrink step 0")
    w.check("shrink mid 1")
    w.add_rule(2, 256, 7001)
    jt, tt = w.compile()
    assert w.publish(jt, tt, delta="current").mode == "delta"
    jp.on_publish(jt)
    tp_.on_publish(tt)
    w.want = w.oracle()
    _stream(w, jp, tp_, "shrink drain", CHECK_EVERY)
    out, jout = tp_.cutover(), jp.cutover()
    _same_stats(out, jout, "shrink")
    assert out["restarts"] == 0 and (w.tr.dp, w.tr.tp) == (2, 2)
    assert w.tr.ordinals.tolist() == [[0, 1], [4, 5]]
    w.check("shrink post-cutover")
