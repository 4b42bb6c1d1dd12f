"""The feed and the completion count: the pool's FASTA with each pass's
read numbers as names; the highest read number the SAM has shown, with
reads that wrote nothing (unmapped) and pairs; and the CLI windows that
time the window."""
import os
import threading
import time

import numpy as np
import pytest

from mapbench import run


def _feed(lines_per_piece, pause=0.0):
    r, w = os.pipe()

    def writer():
        with os.fdopen(w, "wb") as f:
            for piece in lines_per_piece:
                f.write(piece)
                f.flush()
                time.sleep(pause)
    t = threading.Thread(target=writer)
    t.start()
    return r, t


def test_highest_read_number_counts_unmapped_reads():
    # reads 0..9; 3, 4 and 7 write no record; 5 writes two
    recs = [b"@HD\tVN:1.0\n"]
    for n in range(10):
        if n in (3, 4, 7):
            continue
        recs.append(b"%010d\t0\tc\t1\n" % n)
        if n == 5:
            recs.append(b"%010d\t256\tc\t9\n" % n)
    data = b"".join(recs)
    r, t = _feed([data[:25], data[25:60], data[60:]])
    coll = run.Collector(r, 4, np.array([1, 3]))
    coll.run()
    t.join()
    assert coll.done() == 9
    assert [top for _, top in coll.pieces][-1] == 9
    # pool of 4: sampled entries 1 and 3 are reads 1, 5, 9 and 3, 7
    assert sorted(coll.records) == [1, 5, 9]
    assert coll.records[5] == ["0\tc\t1", "256\tc\t9"]


def test_pairs_count_by_pair_number():
    recs = []
    for n in range(6):
        recs.append(b"%010d\t67\tc\t1\n%010d\t131\tc\t100\n" % (n, n))
    r, t = _feed([b"".join(recs)])
    coll = run.Collector(r, 6, np.array([2]))
    coll.run()
    t.join()
    assert coll.done() == 5
    assert len(coll.records[2]) == 2


def test_cli_window_ends():
    # windows of 10 reads; pieces (time, highest read number)
    pieces = [(0.1, 4), (0.2, 9), (1.0, 13), (1.2, 18), (2.0, 22),
              (2.1, 29), (2.9, 35)]
    # window 3 has no successor yet: its end is not known
    assert run.window_ends(pieces, 10, 0.0, 5.0) == [
        (0.2, 0), (1.2, 1), (2.1, 2)]
    assert run.window_ends(pieces, 10, 0.5, 2.5) == [(1.2, 1), (2.1, 2)]


def test_a_qname_of_other_width_is_an_error():
    r, t = _feed([b"12\t0\tc\t1\n"])
    coll = run.Collector(r, 4, np.array([0]))
    coll.run()
    t.join()
    assert coll.error and "QNAME" in coll.error


@pytest.mark.parametrize("paired", [False, True])
def test_feed_names_each_pass_by_read_number(paired):
    pool = ([(b"AC", b"GGT"), (b"T", b"CA"), (b"GA", b"A")] if paired
            else [b"ACG", b"T", b"GGAC"])
    r, w = os.pipe()
    feeder = run.Feeder(w, pool, paired)
    feeder.start()
    want = b"".join(
        (b">%010d/1\n%s\n>%010d/2\n%s\n" % (n, pool[n % 3][0], n,
                                               pool[n % 3][1])
         if paired else b">%010d\n%s\n" % (n, pool[n % 3]))
        for n in range(7))
    got = b""
    while len(got) < len(want):
        got += os.read(r, len(want) - len(got))
    feeder.stop.set()
    os.close(r)
    feeder.join(10)
    os.close(w)
    assert got == want
    assert feeder.error is None
