"""The share of the span slice's compiles at call that the compiler's memo
answered: ``compile.memo_hit`` over ``compile.memo_hit`` + ``compile.fresh``,
in % (``spans.py``); ``None`` where no request plans."""
from portbench.metrics.spans import measure


def read(run):
    sl = measure(run)
    if sl is None:
        return None
    hits, fresh = sl.counts["compile.memo_hit"], sl.counts["compile.fresh"]
    return hits / (hits + fresh) * 100.0 if hits + fresh else None
