"""nw_tpu_torch's CLI on the CPU (``NW_TPU_PLATFORM=cpu``, the kernels'
plain PyTorch versions): the goldens of tests/test_cli.py, carried over
with their expected bytes, and a differential grid that holds it byte
for byte (stdout, stderr, exit code) against nw_tpu's CLI."""

import io
from functools import lru_cache

import numpy as np
import pytest
import torch

from nw_tpu import cli as jcli
from nw_tpu_torch import cli
from nw_tpu_torch.ops.encode import encode
from nw_tpu_torch.ops.fill_banded import fill_arrows_banded_single_plain

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("NW_TPU_PLATFORM", "cpu")
    monkeypatch.delenv("NW_TPU_DEBUG", raising=False)
    monkeypatch.delenv("NW_TPU_HUGE_CELLS", raising=False)


def _run(main, args, stdin: bytes, prog="needleman-wunsch"):
    out, err = io.BytesIO(), io.BytesIO()
    rc = main([prog, *args], stdin=io.BytesIO(stdin), stdout=out, stderr=err)
    return rc, out.getvalue(), err.getvalue()


def run(args, stdin: bytes):
    return _run(cli.main, args, stdin)


# ---------------- the goldens of tests/test_cli.py ----------------


def g_basic_gt_gt(mp):
    rc, out, err = run(["1", "1", "1"], b"GT GT")
    assert rc == 0
    assert out == b"GT\nGT\n\n"
    assert err == b""


def g_counts_line(mp):
    rc, out, err = run(["-l", "1", "1", "1"], b"GT GA")
    assert out == b"GT\nGA\n1 match, 1 mismatch, 0 indels\n\n"


def g_multiple_alignments_order(mp):
    rc, out, err = run(["1", "1", "1"], b"GAT GTA")
    assert out == b"G-AT\nGTA-\n\nGAT-\nG-TA\n\n"


def g_readme_example_summary_to_stderr(mp):
    rc, out, err = run(["-s", "1", "1", "1"], b"GCATGCU GATTACA")
    assert out == (
        b"GCA-TGCU\nG-ATTACA\n\n"
        b"GCAT-GCU\nG-ATTACA\n\n"
        b"GCATG-CU\nG-ATTACA\n\n"
    )
    assert err == b"3 optimal alignments\nOptimal score is 0\n"


def g_quiet_summary_only(mp):
    rc, out, err = run(["-q", "-s", "1", "1", "1"], b"GCATGCU GATTACA")
    assert out == b""
    assert err == b"3 optimal alignments\nOptimal score is 0\n"


def g_quiet_no_flags_no_output(mp):
    rc, out, err = run(["-q", "1", "1", "1"], b"GCATGCU GATTACA")
    assert rc == 0 and out == b"" and err == b""


def g_singular_pluralization(mp):
    rc, out, err = run(["-q", "-s", "1", "1", "1"], b"GT GT")
    assert err == b"1 optimal alignment\nOptimal score is 2\n"


TABLE_ASCII = (
    b"\n"
    b"*     -     G     C     A     T     G     C     U\n"
    b"                                                 \n"
    b"-    +0  < -1  < -2  < -3  < -4  < -5  < -6  < -7\n"
    b"      ^  \\                       \\               \n"
    b"G    -1    +1  < +0  < -1  < -2  < -3  < -4  < -5\n"
    b"      ^     ^  \\     \\                           \n"
    b"A    -2    +0    +0    +1  < +0  < -1  < -2  < -3\n"
    b"      ^     ^  \\  ^     ^  \\                     \n"
    b"T    -3    -1    -1    +0    +2  < +1  < +0  < -1\n"
    b"      ^     ^  \\  ^     ^  \\  ^  \\     \\     \\   \n"
    b"T    -4    -2    -2    -1    +1    +1  < +0  < -1\n"
    b"      ^     ^  \\  ^  \\        ^  \\  ^  \\     \\   \n"
    b"A    -5    -3    -3    -1    +0    +0    +0  < -1\n"
    b"      ^     ^  \\        ^     ^  \\  ^  \\         \n"
    b"C    -6    -4    -2    -2    -1    -1    +1  < +0\n"
    b"      ^     ^     ^  \\        ^  \\  ^     ^  \\   \n"
    b"A    -7    -5    -3    -1  < -2    -2    +0    +0\n"
)


def g_table_ascii(mp):
    rc, out, err = run(["-q", "-s", "-t", "1", "1", "1"], b"GCATGCU GATTACA")
    assert out == TABLE_ASCII
    assert err == b"3 optimal alignments\nOptimal score is 0\n"


def g_atoi_garbage_operands(mp):
    rc, out, err = run(["-q", "-s", "x", "y", "z"], b"GT GA")
    assert err == b"13 optimal alignments\nOptimal score is 0\n"


def g_usage_exits_1(mp):
    rc, out, err = run(["-h", "1", "1", "1"], b"")
    assert rc == 1
    assert err.startswith(b"usage: needleman-wunsch")
    assert out == b""


def g_operand_count_errors(mp):
    rc, out, err = run([], b"")
    assert rc == 1
    assert err.startswith(
        b"needleman-wunsch: error: expected 3 operands but received 0: \x08\x08 \x08\n"
    )
    rc, out, err = run(["1", "1"], b"")
    assert b"received only 2" in err
    rc, out, err = run(["1", "1", "1", "1", "1"], b"")
    assert b"received 5" in err and b"only 5" not in err


def g_p_flag_validation(mp):
    rc, out, err = run(["-p", "1", "1", "1", "1"], b"GT GT")
    assert rc == 1
    assert err == (
        b"needleman-wunsch: error: num-threads == 1; num-threads "
        b"must be greater than 1: \x08\x08 \x08\n"
    )
    rc, out, err = run(["-p", "4", "1", "1", "1"], b"GT GT")
    assert rc == 0 and out == b"GT\nGT\n\n"


def g_eof_too_early(mp):
    rc, out, err = run(["1", "1", "1"], b"GT")
    assert rc == 1
    assert err == (
        b"needleman-wunsch: error: got EOF too early when reading input "
        b"strings: \x08\x08 \x08\n"
    )


def g_bad_file(mp):
    rc, out, err = run(["-f", "/nonexistent-nw", "1", "1", "1"], b"")
    assert rc == 1
    assert err == (
        b"needleman-wunsch: error: failed to open /nonexistent-nw: "
        b"No such file or directory\n"
    )


def g_invalid_option_glibc_message(mp):
    rc, out, err = run(["-z", "1", "1", "1"], b"")
    assert rc == 1
    assert err.startswith(b"needleman-wunsch: invalid option -- 'z'\n")


def g_color_output(mp):
    rc, out, err = run(["-c", "1", "1", "1"], b"GT GA")
    # G match (empty fmt + reset), T mismatch (red;bold + reset)
    assert out == (
        b"G\x1b[0m\x1b[31;1mT\x1b[0m\n"
        b"G\x1b[0m\x1b[31;1mA\x1b[0m\n\n"
    )


def g_unicode_table(mp):
    rc, out, err = run(["-q", "-t", "-u", "1", "1", "1"], b"GT GT")
    text = out.decode("utf-8")
    assert "↖" in text and "←" in text and "↑" in text


def g_empty_first_sequence(mp):
    rc, out, err = run(["-s", "1", "1", "1"], b" GT GA")
    assert out == b"--\nGT\n\n"
    assert err == b"1 optimal alignment\nOptimal score is -2\n"


def g_huge_path_byte_identical(mp):
    """Forcing the huge-pair route (-q / -q -s) gives the same bytes as
    the full-table route."""
    cases = [
        (["-q", "-s", "1", "1", "1"], b"GCATGCU GATTACA"),
        (["-q", "-s", "2", "1", "1"], b"GATTACA GCATGCU"),
        (["-q", "1", "1", "1"], b"GT GA"),
        (["-q", "-s", "0", "0", "0"], b"GT GA"),
    ]
    normal = [run(a, s) for a, s in cases]
    mp.setenv("NW_TPU_HUGE_CELLS", "1")
    forced = [run(a, s) for a, s in cases]
    assert normal == forced


def g_count_beyond_reference_reach_delannoy(mp):
    """-q -s 0 0 0 on all-'A' strings: every monotone path is optimal,
    so the count is the Delannoy number D(24,16) mod 2^32 (%d)."""

    @lru_cache(None)
    def delannoy(m, n):
        if m == 0 or n == 0:
            return 1
        return delannoy(m - 1, n) + delannoy(m, n - 1) + delannoy(m - 1, n - 1)

    d = delannoy(24, 16) % 2**32
    signed = d - 2**32 if d >= 2**31 else d
    rc, out, err = run(["-q", "-s", "0", "0", "0"], b"A" * 24 + b" " + b"A" * 16)
    assert rc == 0 and out == b""
    assert err == b"%d optimal alignments\nOptimal score is 0\n" % signed


GOLDENS = [v for k, v in sorted(globals().items()) if k.startswith("g_")]


@pytest.mark.parametrize("golden", GOLDENS, ids=[g.__name__[2:] for g in GOLDENS])
def test_golden(golden, monkeypatch):
    golden(monkeypatch)


def test_goldens_cover_test_cli():
    assert len(GOLDENS) == 20


# ---------------- differential grid against nw_tpu's CLI ----------------

SCORINGS = [(1, 1, 1), (2, 1, 1), (0, 0, 0), (3, -1, 2)]
# (flags, NW_TPU_DEBUG, NW_TPU_HUGE_CELLS)
FLAGS = [
    ([], None, None),
    (["-l"], None, None),
    (["-s"], None, None),
    (["-q", "-s"], None, None),
    (["-q", "-t", "-s"], None, None),
    (["-t", "-u", "-c"], None, None),
    (["-s"], "1", None),
    (["-q", "-s"], None, "1"),  # the forced huge route (K8)
]
MAX_PRINTED = 200  # alignments a printing case may enumerate


def _grid_pairs():
    """12 seeded pairs in three length classes (JAX buckets 16, 32, 64),
    half random ACGT, half tie-dense AC."""
    rng = np.random.default_rng(2026)
    pairs = []
    for lo, hi in ((0, 16), (17, 32), (33, 40)):
        for alphabet in (b"ACGT", b"ACGT", b"AC", b"AC"):
            letters = np.frombuffer(alphabet, np.uint8)
            n1, n2 = (int(x) for x in rng.integers(lo, hi + 1, 2))
            pairs.append((
                letters[rng.integers(0, len(letters), n1)].tobytes(),
                letters[rng.integers(0, len(letters), n2)].tobytes(),
            ))
    return pairs


PAIRS = _grid_pairs()


def _exact_count(s1, s2, mkd) -> int:
    """The unbounded number of optimal alignments (Python ints)."""
    masks = fill_arrows_banded_single_plain(
        torch.from_numpy(encode(s1)), torch.from_numpy(encode(s2)), *mkd
    )[0].numpy()
    N, M = masks.shape
    paths = [[0] * M for _ in range(N)]
    paths[0][0] = 1
    for j in range(N):
        for i in range(M):
            a = int(masks[j, i])
            if a & 1:
                paths[j][i] += paths[j - 1][i - 1]
            if a & 2:
                paths[j][i] += paths[j][i - 1]
            if a & 4:
                paths[j][i] += paths[j - 1][i]
    return paths[N - 1][M - 1]


def _printable(s1, s2, mkd):
    """The pair cut from its ends until its alignments can be printed."""
    while _exact_count(s1, s2, mkd) > MAX_PRINTED:
        s1, s2 = s1[: max(len(s1) - 2, 0)], s2[: max(len(s2) - 2, 0)]
    return s1, s2


@pytest.mark.parametrize("flags,debug,huge", FLAGS)
@pytest.mark.parametrize("mkd", SCORINGS)
@pytest.mark.parametrize("pair", range(len(PAIRS)))
def test_differential_vs_nw_tpu(pair, mkd, flags, debug, huge, monkeypatch):
    s1, s2 = PAIRS[pair]
    if "-q" not in flags:
        s1, s2 = _printable(s1, s2, mkd)
    if debug:
        monkeypatch.setenv("NW_TPU_DEBUG", debug)
    if huge:
        monkeypatch.setenv("NW_TPU_HUGE_CELLS", huge)
    args = [*flags, "--", *(str(v) for v in mkd)]  # "--": k may be negative
    stdin = s1 + b"\n" + s2 + b"\n"
    assert _run(cli.main, args, stdin) == _run(jcli.main, args, stdin)


@pytest.mark.parametrize(
    "args,stdin",
    [
        (["-s", "1", "1", "1"], b"\x00 \x00"),  # NULs truncate: the 0 x 0 table
        (["-q", "-t", "-s", "1", "1", "1"], b"\x00 \x00"),
        (["-l", "-s", "2", "1", "1"], b" A\x00CG CAT"),
        (["-q", "-s", "2147483647", "-2147483648", "1073741824"], b"GATTACA GCAT"),
    ],
)
def test_differential_edge_inputs(args, stdin):
    assert _run(cli.main, args, stdin) == _run(jcli.main, args, stdin)


def test_no_card_refuses(monkeypatch):
    """No card and no NW_TPU_PLATFORM=cpu: exit 1 with an error; nothing
    is computed on the CPU."""
    from nw_tpu_torch.ops import fill_banded, fill_single

    def cpu_run(*args, **kw):
        raise AssertionError("the plain path ran")

    monkeypatch.setattr(fill_banded, "fill_arrows_banded_single_plain", cpu_run)
    monkeypatch.setattr(fill_single, "score_count_fold_plain", cpu_run)
    monkeypatch.delenv("NW_TPU_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(["-s", "1", "1", "1"], b"GCATGCU GATTACA")
    assert rc == 1 and out == b""
    assert err.startswith(b"needleman-wunsch: error: no CUDA device is available")
    monkeypatch.setenv("NW_TPU_PLATFORM", "tpu")
    rc, out, err = run(["-s", "1", "1", "1"], b"GT GA")
    assert rc == 1 and out == b"" and b"NW_TPU_PLATFORM=tpu" in err


@pytest.mark.parametrize("mkd", [(1, 1, 1 << 30), (1, 1 << 30, 1), (2**31 - 1, -(2**31), 1 << 30)])
def test_huge_route_follows_fill_scan_at_large_scorings(mkd, monkeypatch):
    """Past the NEG_INF = -2^30 envelope nw_tpu's K8 (score_count_fold)
    leaves its own fill_scan; the port's huge route keeps fill_scan's
    answer, which nw_tpu's table route prints."""
    args = ["-q", "-s", "--", *(str(v) for v in mkd)]
    stdin = b"GATTACA GCAT"
    want = _run(jcli.main, args, stdin)  # nw_tpu's table route (fill_scan)
    assert _run(cli.main, args, stdin) == want
    monkeypatch.setenv("NW_TPU_HUGE_CELLS", "1")
    assert _run(cli.main, args, stdin) == want
