"""The `precluster_count` job: `inverted precluster <ski> --count --quiet`
over an `index` database, which prints the number of sample pairs that
share a sign in some bin.

Traffic keys: none. Checked on every job of the window: count_gap, the
most by which a job's printed count (or its line) departs from the plain
reference's (reference/count.py); exact, limit 0."""

from __future__ import annotations

from portbench.reference.count import shared_pair_count

LIMITS = {"count_gap": 0}


def argv(db, traffic, out) -> list[str]:
    return ["inverted", "precluster", str(db.prefix), "--count", "--quiet"]


def pairs(db, traffic) -> int:
    return db.n * (db.n - 1) // 2


def shapes(db, traffic) -> dict:
    return {"n": db.n, "signs": db.signs.shape[1]}


def count_line(count: int, n: int) -> str:
    return f"Identified {count} prefilter pairs from a max of {n * (n - 1) // 2}\n"


def gap(printed: str, want: int, n: int) -> int:
    """|printed count - want|, or n(n-1)/2 + 1 where the line is not the
    one the reference tool prints."""
    parts = printed.split(" ")
    try:
        count = int(parts[1])
    except (IndexError, ValueError):
        return n * (n - 1) // 2 + 1
    if printed != count_line(count, n):
        return n * (n - 1) // 2 + 1
    return abs(count - want)


def check(db, traffic, record, seed: int, device) -> dict:
    want = shared_pair_count(db.signs, device)
    return {"count_gap": max(gap(s, want, db.n) for s in record.stdout)}


def control(db, traffic, seed: int, device, workdir) -> dict:
    """count_gap of the count one step down: signs compared at 8 bits (their
    low byte) against the reference's 16. The reference cannot count at 8
    bits at this size (a third of all pairs share a byte), so the port
    counts an index of the low bytes."""
    import contextlib
    import io

    from portbench.databases import index
    from sketchtpu_torch import cli

    path = index.write(workdir / "low8.ski", db.signs & 0xFF, db.names, db.k)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["inverted", "precluster", str(path), "--count", "--quiet"])
    return {"count_gap": gap(buf.getvalue(), shared_pair_count(db.signs, device),
                             db.n)}
