"""The frozen chunk window against the CLI's on a stub engine: the same
chunks, dispatched and collected in the same order."""

from types import SimpleNamespace

import pytest

from benchmark.harness.window import run_window

CHUNKS = 7


class Stub:
    """An engine that records each dispatch and collect by the first read
    of its chunk and fails every read (so that nothing is formatted)."""

    def __init__(self):
        self.log = []

    def dispatch(self, items):
        self.log.append(("dispatch", items[0].meta_id, len(items)))
        return items

    def collect(self, handle):
        self.log.append(("collect", handle[0].meta_id, len(handle)))
        return [SimpleNamespace(item=it, error="stub") for it in handle]


def _cli_log():
    from dynamont_tpu_torch.cli import resquiggle as cli

    eng = Stub()

    def item(signal, read, job):
        return SimpleNamespace(signal=signal, read=read, meta=job, meta_id=job.i)

    jobs = [SimpleNamespace(i=i, signal=[0.0], read="A", readid=str(i),
                            signalid=str(i)) for i in range(CHUNKS * 128)]
    writer = SimpleNamespace(put_error=lambda e: None, put_result=lambda b: None)
    args = SimpleNamespace(batch_size=None)
    mp = pytest.MonkeyPatch()
    import dynamont_tpu_torch.models.batch as mb

    mp.setattr(mb, "BatchItem", item)
    try:
        cli._pump_engine(args, eng, iter(jobs), writer, True, None, "error: ")
    finally:
        mp.undo()
    return eng.log, cli.INFLIGHT


def test_window_order_is_the_cli_order():
    cli_log, inflight = _cli_log()
    eng = Stub()
    program = SimpleNamespace(
        dispatch=eng.dispatch, collect=eng.collect, format=lambda o: b"",
        items=lambda reads, ids: [SimpleNamespace(meta=i, meta_id=i) for i in ids])
    ticks = iter([0.0] + [0.0] * CHUNKS + [1e9] * 10)
    res = run_window(program, [None] * (CHUNKS * 128), seconds=1.0,
                     chunk_reads=128, inflight=inflight, clock=lambda: next(ticks))
    assert inflight == 3
    assert eng.log == cli_log
    assert res.attempted == res.done == res.failed == CHUNKS * 128
    assert res.chunks == CHUNKS
