"""The port's kernels against their plain versions, on the card.

These tests need an NVIDIA card and nvcc: the CUDA kernel has no CPU
mode, so on a CPU-only host they skip. The file imports neither jax nor
tpu_mpi, so it runs on a machine without them, apart from the repo's
conftest (which sets up jax):

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from tpu_mpi_torch.kernels import fused_reduce as fr


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16,
                                   torch.float64, torch.int8, torch.int64,
                                   torch.uint8, torch.bool])
@pytest.mark.parametrize("n", [2, 17])
def test_kernel_matches_plain_on_card(dtype, n):
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    if dtype.is_floating_point:
        xs = [torch.randn(4097, generator=g, device=dev).to(dtype)
              for _ in range(n)]
    else:
        xs = [torch.randint(0, 2 if dtype == torch.bool else 100, (4097,),
                            generator=g, device=dev).to(dtype)
              for _ in range(n)]
    for op in ("SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR"):
        if not fr.supports(op, dtype):
            continue
        before = fr.launches
        got = fr.fused_multi_reduce(xs, op)
        want = fr.fused_multi_reduce_plain(xs, op)
        torch.cuda.synchronize()
        assert fr.launches == before + 1
        assert torch.equal(got, want), (dtype, op, n)


@pytest.mark.cuda
def test_kernel_rejects_non_contiguous_on_card():
    dev = _card()
    x = torch.zeros(64, device=dev)
    with pytest.raises(ValueError):
        fr.fused_multi_reduce([x[::2], x[1::2]], "SUM")


# ---------------------------------------------------------------------------
# The fold kernel's two routes, each forced through the wrapper's ``via``
# ---------------------------------------------------------------------------

_FOLD_DTYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
                torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
                torch.uint16, torch.uint32, torch.uint64, torch.bool]
_FOLD_OPS = ("SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR",
             "NUMPY_SUM", "NUMPY_PROD", "NUMPY_MAX", "NUMPY_MIN")
_ROUTE_COUNTS = (1, 3, 127, 4097, (1 << 20) + 5)


def _draw(dtype, shape, dev, gen):
    """Normal floats, 0/1 bools, and random bytes for every integer type
    (so SUM and PROD wrap and the unsigned types reach their top bit)."""
    if dtype.is_floating_point:
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    if dtype == torch.bool:
        return torch.randint(0, 2, shape, generator=gen, device=dev).bool()
    width = torch.empty((), dtype=dtype).element_size()
    return torch.randint(0, 256, (*shape[:-1], shape[-1] * width), generator=gen,
                         device=dev, dtype=torch.uint8).view(dtype)


def _same_bits(got, want, exact=False):
    """Bit for bit; floats under the predefined ops by NaN position and the
    bits of every other element (``exact``: NaN payloads too)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False
    if got.dtype.is_floating_point and not exact:
        nan = torch.isnan(want)
        if not torch.equal(torch.isnan(got), nan):
            return False
        got, want = got[~nan], want[~nan]
    return torch.equal(got.contiguous().view(torch.uint8),
                       want.contiguous().view(torch.uint8))


def _fold_via(xs, op, way, out=None):
    """One forced-route call: its result, after checking it was counted once
    on that route."""
    before, routes = fr.launches, dict(fr.route_launches)
    got = fr.fused_multi_reduce(xs, op, out=out, via=way)
    torch.cuda.synchronize()
    assert fr.launches == before + 1
    assert fr.route_launches[way] == routes[way] + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 4, 5, 16, 17])
@pytest.mark.parametrize("dtype", _FOLD_DTYPES, ids=str)
def test_fold_routes_match_plain_on_card(dtype, n):
    """Both routes, forced, bitwise against the plain fold, for every op the
    kernel takes on the dtype: the ragged counts on the direct route (the
    staged route refuses them), the same counts rounded up to whole 16-byte
    words on both. n = 1 folds into an ``out`` (the persistent lane's copy);
    n = 17 is a chained launch."""
    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(15 + n)
    v = 16 // dtype.itemsize
    ops = [op for op in _FOLD_OPS if fr.supports(op, dtype)]
    for count in _ROUTE_COUNTS:
        words = -(-count // v) * v
        sizes = {count: ("direct",), words: ("staged", "direct")}
        for size, ways in sizes.items():
            xs = [_draw(dtype, (size,), dev, gen) for _ in range(n)]
            if size % v:
                with pytest.raises(ValueError, match="staged route"):
                    fr.fused_multi_reduce(xs, "SUM", out=torch.empty_like(xs[0]),
                                          via="staged")
            for op in ops:
                want = fr.fused_multi_reduce_plain(xs, op)
                for way in ways:
                    out = torch.empty_like(xs[0])
                    got = _fold_via(xs, op, way, out=out)
                    assert got is out
                    assert _same_bits(got, want, op.startswith("NUMPY")), \
                        (dtype, op, n, size, way)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _FOLD_DTYPES, ids=str)
def test_fold_offset_views_take_the_direct_route_on_card(dtype):
    """Operands and out that are views at a 1-element storage offset take
    the direct route on their own, refuse the staged one, and fold bitwise
    as the plain version does."""
    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    ops = [op for op in _FOLD_OPS if fr.supports(op, dtype)]
    for n in (2, 5, 17):
        for count in (127, 4097, (1 << 20) + 5):
            base = _draw(dtype, (n + 1, count + 1), dev, gen)
            xs = [base[k, 1:] for k in range(n)]
            assert fr.route(xs, torch.empty_like(xs[0])) == "direct"
            with pytest.raises(ValueError, match="staged route"):
                fr.fused_multi_reduce(xs, "SUM", via="staged")
            for op in ops:
                want = fr.fused_multi_reduce_plain(xs, op)
                routes = dict(fr.route_launches)
                got = fr.fused_multi_reduce(xs, op, out=base[n, 1:])
                torch.cuda.synchronize()
                assert fr.route_launches["direct"] == routes["direct"] + 1
                assert _same_bits(got, want, op.startswith("NUMPY")), (dtype, op, n, count)


@pytest.mark.cuda
@pytest.mark.parametrize("way", ["staged", "direct"])
@pytest.mark.parametrize("n", [1, 2, 4, 16, 17])
def test_fold_into_operand_0_on_card(n, way):
    """``out`` aliasing operand 0 (the RMA accumulate in place, the
    accumulator of a chained launch) on each route, bitwise."""
    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    counts = ((1 << 20) + 16, 4096) + (((1 << 20) + 5, 3) if way == "direct" else ())
    for dtype in (torch.float32, torch.float16, torch.int64, torch.bool):
        for count in counts:
            for op in ("SUM", "MAX"):
                xs = [_draw(dtype, (count,), dev, gen) for _ in range(n)]
                want = fr.fused_multi_reduce_plain(xs, op).clone()
                got = _fold_via(xs, op, way, out=xs[0])
                assert got is xs[0] and _same_bits(got, want), (dtype, count, op)


@pytest.mark.cuda
@pytest.mark.parametrize("way", ["staged", "direct"])
def test_fold_into_every_operand_on_card(way):
    """``out`` aliasing operand k of 17 for every k, bitwise: operand 16 is
    past the first launch's 16, whose chained launch leads with the
    accumulator, so the wrapper folds it fresh and copies it in."""
    dev = _card()
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    counts = (4096,) + ((4097,) if way == "direct" else ())
    for dtype in (torch.float32, torch.int64):
        for count in counts:
            for op in ("SUM", "MAX"):
                for k in range(17):
                    xs = [_draw(dtype, (count,), dev, gen) for _ in range(17)]
                    want = fr.fused_multi_reduce_plain(xs, op)
                    got = _fold_via(xs, op, way, out=xs[k])
                    assert got is xs[k] and _same_bits(got, want), (dtype, count, op, k)


_NAN_BITS = {   # a signalling NaN with a payload, then a quiet negative one
    "float16": (0x7C05, 0xFE34, 0x0200),
    "float32": (0x7F800005, 0xFFC05678, 0x00400000),
    "float64": (0x7FF0000000000005, 0xFFF8000000005678, 0x0008000000000000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("way", ["staged", "direct"])
@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_numpy_rule_nan_payloads_of_two_ranks_on_card(dtype, way):
    """Ranks 1 and 2 of 4 hold NaNs with payloads at every element. Every
    NUMPY_* step gives the plain version's bits, NaN payload and all: rank
    1's payload survives (quieted by SUM/PROD), as the accumulator-first
    step order gives it, except float16 SUM/PROD, where numpy's half loop
    keeps the later operand's (rank 2's)."""
    import numpy as np
    dev = _card()
    tdt = getattr(torch, dtype)
    first, second, quiet = _NAN_BITS[dtype]
    sint = {2: torch.int16, 4: torch.int32, 8: torch.int64}[tdt.itemsize]
    ubits = np.dtype(f"u{tdt.itemsize}")

    def nan_tensor(bits, count):
        raw = np.full(count, bits, ubits).view(np.dtype(dtype))
        return torch.from_numpy(raw).to(dev)

    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    for count in (4096, 8, (1 << 20) + 8):
        xs = [_draw(tdt, (count,), dev, gen), nan_tensor(first, count),
              nan_tensor(second, count), _draw(tdt, (count,), dev, gen)]
        for op in ("NUMPY_SUM", "NUMPY_PROD", "NUMPY_MAX", "NUMPY_MIN"):
            want = fr.fused_multi_reduce_plain(xs, op)
            got = _fold_via(xs, op, way)
            assert _same_bits(got, want, exact=True), (op, count)
            later = dtype == "float16" and op in ("NUMPY_SUM", "NUMPY_PROD")
            kept = second if later else first
            bits = got.view(sint).cpu().numpy().view(ubits)
            want_bits = np.array(kept | quiet, ubits)
            assert ((bits | np.array(quiet, ubits)) == want_bits).all(), (op, count)


@pytest.mark.cuda
def test_allreduce_main_path_on_card():
    import numpy as np
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import collective
    _card()
    rng = np.random.default_rng(1)
    data = [rng.standard_normal(3001).astype(np.float32) for _ in range(4)]
    want = fr.fused_multi_reduce_plain(
        [torch.from_numpy(d).cuda() for d in data], "SUM")
    before, chained = fr.launches, collective.chained_folds

    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = MPI.DeviceBuffer(data[r])
        y = MPI.DeviceBuffer(np.zeros(3001, np.float32))
        for _ in range(6):
            MPI.Allreduce(x, y, MPI.SUM, comm)
            assert y.value.is_cuda and torch.equal(y.value, want)
        req = MPI.Allreduce_init(x, y, MPI.SUM, comm)
        for _ in range(3):
            MPI.Start(req)
            MPI.Wait(req)
            assert torch.equal(y.value, want)

    MPI.testing.run_spmd(body, 4, timeout=120)
    assert fr.launches >= before + 9
    assert collective.chained_folds == chained


# ---------------------------------------------------------------------------
# Ring kernels (tpu_mpi_torch.kernels.ring)
# ---------------------------------------------------------------------------

_RING_DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.float64,
                torch.int8, torch.int32, torch.int64, torch.uint8, torch.bool]


def _stacked(dtype, n, count, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if dtype.is_floating_point:
        return torch.randn(n, count, generator=g, device=dev).to(dtype)
    hi = 2 if dtype == torch.bool else 100
    return torch.randint(0, hi, (n, count), generator=g, device=dev).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _RING_DTYPES)
@pytest.mark.parametrize("n", [2, 5])
def test_ring_kernels_match_plain_on_card(dtype, n):
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch.kernels import ring
    dev = _card()
    xs = _stacked(dtype, n, 8229, dev, 7)
    blocks = _stacked(dtype, n, n * 1031, dev, 8)
    for name in ("SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR"):
        if not fr.supports(name, dtype):
            continue
        op = getattr(MPI, name)
        combine = ring._combine_fn(op)[1]
        before = dict(ring.launches)
        got = ring.ring_allreduce(xs, op)
        want = ring.ring_allreduce_plain(xs, combine)
        got_rs = ring.ring_reduce_scatter(blocks, op)
        want_rs = ring.ring_reduce_scatter_plain(blocks, combine)
        torch.cuda.synchronize()
        assert ring.launches["ring_allreduce"] == before["ring_allreduce"] + 1
        assert ring.launches["ring_reduce_scatter"] == \
            before["ring_reduce_scatter"] + 1
        assert torch.equal(got, want), (dtype, name, n)
        assert torch.equal(got_rs, want_rs), (dtype, name, n)
    for shard in (xs, xs[:, 1:].contiguous()):       # 16-byte and narrower words
        before = ring.launches["ring_allgather"]
        got = ring.ring_allgather(shard)
        torch.cuda.synchronize()
        assert ring.launches["ring_allgather"] == before + 1
        assert torch.equal(got, ring.ring_allgather_plain(shard))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["non-contiguous", "no ranks", "indivisible",
                                 "dtype"])
def test_ring_kernels_refuse_on_card(bad):
    from tpu_mpi_torch.kernels import ring
    dev = _card()
    x = torch.zeros(4, 64, device=dev)
    before = dict(ring.launches)
    with pytest.raises(ValueError):
        if bad == "non-contiguous":
            ring.ring_allreduce(x[:, ::2], "sum")
        elif bad == "no ranks":
            ring.ring_allgather(torch.zeros(0, 64, device=dev))
        elif bad == "indivisible":
            ring.ring_reduce_scatter(torch.zeros(4, 10, device=dev), "sum")
        else:
            ring.ring_allreduce(x.to(torch.complex64), "sum")
    assert ring.launches == before


@pytest.mark.cuda
def test_ingraph_tier_on_card():
    import numpy as np
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import collective, xla
    from tpu_mpi_torch.kernels import ring
    _card()
    mesh = xla.make_mesh({"x": 4})
    assert mesh.device.type == "cuda"
    rng = np.random.default_rng(2)
    xs = torch.from_numpy(rng.standard_normal((4, 4 * 3001)).astype(np.float32)
                          ).to(mesh.device)
    folds, chained = fr.launches, collective.chained_folds
    before = dict(ring.launches)
    total = xla.allreduce(xs, MPI.SUM)
    shards = xla.reduce_scatter(xs, MPI.SUM)
    back = xla.allgather(shards, tiled=True)
    torch.cuda.synchronize()
    want = fr.fused_multi_reduce_plain(list(xs), "SUM")
    assert total.is_cuda and torch.equal(total[3], want)
    assert torch.equal(back[1], want)
    assert fr.launches == folds + 2
    assert ring.launches["ring_allgather"] == before["ring_allgather"] + 1
    assert collective.chained_folds == chained


# ---------------------------------------------------------------------------
# Permute and alltoall kernels (tpu_mpi_torch.kernels.permute)
# ---------------------------------------------------------------------------

_MOVE_DTYPES = [torch.float32, torch.bfloat16, torch.float64, torch.int8,
                torch.int32, torch.int64, torch.bool]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _MOVE_DTYPES)
@pytest.mark.parametrize("n,per", [(2, 4097), (5, 127), (8, 1),
                                   (4, 1024)])      # 16-byte words
def test_permute_kernels_match_plain_on_card(dtype, n, per):
    from tpu_mpi_torch.kernels import permute
    dev = _card()
    xs = _stacked(dtype, n, n * per, dev, 11)
    g = torch.Generator().manual_seed(n)
    perm = torch.randperm(n, generator=g).tolist()
    partial = [-1 if d % 3 == 1 else (d + 1) % n for d in range(n)]
    before = dict(permute.launches)
    cases = [
        (permute.collective_permute(xs, perm),
         permute.permute_rows_plain(xs, permute.inverse(perm, n))),
        (permute.permute_rows(xs, partial), permute.permute_rows_plain(xs, partial)),
        (permute.permute_rows(xs[:, 1:].contiguous(), partial),   # narrower words
         permute.permute_rows_plain(xs[:, 1:], partial)),
        (permute.pairwise_alltoall(xs), permute.pairwise_alltoall_plain(xs)),
    ]
    torch.cuda.synchronize()
    assert permute.launches["collective_permute"] == before["collective_permute"] + 3
    assert permute.launches["pairwise_alltoall"] == before["pairwise_alltoall"] + 1
    for got, want in cases:
        assert got.is_cuda and torch.equal(got, want), (dtype, n, per)


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["non-contiguous", "not a permutation",
                                 "source out of range", "indivisible"])
def test_permute_kernels_refuse_on_card(bad):
    from tpu_mpi_torch.kernels import permute
    dev = _card()
    x = torch.zeros(4, 64, device=dev)
    before = dict(permute.launches)
    with pytest.raises(ValueError):
        if bad == "non-contiguous":
            permute.collective_permute(x[:, ::2], [1, 2, 3, 0])
        elif bad == "not a permutation":
            permute.collective_permute(x, [0, 0, 1, 2])
        elif bad == "source out of range":
            permute.permute_rows(x, [0, 1, 2, 4])
        else:
            permute.pairwise_alltoall(torch.zeros(4, 10, device=dev))
    assert permute.launches == before


@pytest.mark.cuda
def test_xla_movement_routes_through_the_kernels_on_card():
    from tpu_mpi_torch import xla
    from tpu_mpi_torch.kernels import permute
    dev = _card()
    x = torch.randn(4, 8, 6, 5, device=dev)
    before = dict(permute.launches)
    got = {
        "alltoall": xla.alltoall(x, split_axis=0, concat_axis=1),
        "untiled": xla.alltoall(x[:, :4].contiguous(), split_axis=0,
                                concat_axis=2, tiled=False),
        "ring_shift": xla.ring_shift(x, shift=-1),
        "sendrecv": xla.sendrecv(x, dest=[2, None, 0, 1]),
    }
    torch.cuda.synchronize()
    assert permute.launches["pairwise_alltoall"] == before["pairwise_alltoall"] + 2
    assert permute.launches["collective_permute"] == before["collective_permute"] + 2
    cpu = x.cpu()
    want = {
        "alltoall": xla.alltoall(cpu, split_axis=0, concat_axis=1),
        "untiled": xla.alltoall(cpu[:, :4].contiguous(), split_axis=0,
                                concat_axis=2, tiled=False),
        "ring_shift": xla.ring_shift(cpu, shift=-1),
        "sendrecv": xla.sendrecv(cpu, dest=[2, None, 0, 1]),
    }
    for name in got:
        assert torch.equal(got[name].cpu(), want[name]), name


# ---------------------------------------------------------------------------
# Ring attention kernel (tpu_mpi_torch.kernels.attention)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n,t,d", [(1, 8, 8), (2, 72, 64), (4, 256, 128),
                                   (3, 13, 40)])
def test_ring_attention_matches_plain_on_card(dtype, causal, n, t, d):
    from tpu_mpi_torch.kernels import attention
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(t + d)
    q, k, v = (torch.randn(n, 3, t, d, generator=g, device=dev).to(dtype)
               for _ in range(3))
    before = attention.launches
    got = attention.attend(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    want = attention.ring_attention_plain(q, k, v, causal=causal,
                                          scale=d ** -0.5)
    limit = attention.allowed_error(q, k, v, want, causal=causal,
                                    scale=d ** -0.5)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= limit).all()), (float(diff.max()),
                                         float((diff - limit).max()))


def _attention_case(dev, n, bh, t, d, dtype, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return [torch.randn(n, bh, t, d, generator=g, device=dev).to(dtype)
            for _ in range(3)]


def _within_bound(attention, got, q, k, v, causal):
    scale = q.shape[-1] ** -0.5
    want = attention.ring_attention_plain(q, k, v, causal=causal, scale=scale)
    limit = attention.allowed_error(q, k, v, want, causal=causal, scale=scale)
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= limit).all()), (float(diff.max()),
                                         float((diff / limit).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,bh,t,d,causal", [
    (4, 128, 256, 64, True),       # the flagship's sp attention
    (4, 128, 256, 64, False),
    (2, 3, 13, 8, True),           # ragged t, below one 64-key tile
    (2, 3, 72, 40, False),         # ragged t past one tile, d below a panel
    (3, 2, 72, 128, True),         # two 64-column panels
    (2, 2, 200, 128, False),
])
def test_sm90_ring_attention_matches_plain_on_card(n, bh, t, d, causal):
    from tpu_mpi_torch.kernels import attention
    dev = _card()
    q, k, v = _attention_case(dev, n, bh, t, d, torch.bfloat16, t + d)
    assert attention.route(q.dtype, d, True) == "sm90"
    before = dict(attention.route_launches)
    got = attention.attend(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attention.route_launches["sm90"] == before["sm90"] + 1
    assert attention.route_launches["mma_sync"] == before["mma_sync"]
    _within_bound(attention, got, q, k, v, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_head_dim_off_eight_takes_the_mma_sync_route(causal):
    from tpu_mpi_torch.kernels import attention
    dev = _card()
    q, k, v = _attention_case(dev, 3, 2, 72, 36, torch.bfloat16, 36)
    before = dict(attention.route_launches)
    got = attention.attend(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attention.route_launches["mma_sync"] == before["mma_sync"] + 1
    assert attention.route_launches["sm90"] == before["sm90"]
    _within_bound(attention, got, q, k, v, causal)


@pytest.mark.cuda
def test_permute_launch_path_two_tables_back_to_back_on_card():
    from tpu_mpi_torch.kernels import permute
    dev = _card()
    xs = _stacked(torch.bfloat16, 4, 4 * 1024, dev, 13)
    before = permute.launches["collective_permute"]
    first = permute.collective_permute(xs, [1, 2, 3, 0])
    second = permute.permute_rows(xs, [2, -1, 0, 1])
    again = permute.collective_permute(xs, [1, 2, 3, 0])
    torch.cuda.synchronize()
    assert permute.launches["collective_permute"] == before + 3
    assert torch.equal(first, xs.roll(1, 0)) and torch.equal(again, first)
    assert torch.equal(second, permute.permute_rows_plain(xs, [2, -1, 0, 1]))


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["non-contiguous", "cpu and cuda", "float16",
                                 "head dim", "seq multiple"])
def test_ring_attention_refuses_on_card(bad):
    from tpu_mpi_torch.kernels import attention
    dev = _card()
    q = torch.zeros(2, 3, 16, 8, device=dev)
    before = attention.launches
    with pytest.raises(ValueError):
        if bad == "non-contiguous":
            attention.attend(q.transpose(1, 2), q.transpose(1, 2),
                             q.transpose(1, 2), causal=True)
        elif bad == "cpu and cuda":
            attention.attend(q, q.cpu(), q, causal=True)
        elif bad == "float16":
            h = q.half()
            attention.attend(h, h, h, causal=True)
        elif bad == "head dim":
            w = torch.zeros(2, 3, 16, 136, device=dev)
            attention.attend(w, w, w, causal=True)
        else:
            r = torch.zeros(2, 12, 8, device=dev)
            attention.ring_attention(r, r, r)
    assert attention.launches == before


@pytest.mark.cuda
def test_sp_transformer_forward_on_card():
    from tpu_mpi_torch.kernels import attention
    from tpu_mpi_torch.models import transformer as tr
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tr.TransformerConfig(vocab=64, d_model=64, n_heads=4, n_layers=2,
                               d_ff=128)
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    params = tr.transformer_init(g, cfg, device=dev)
    tokens = torch.randint(0, 64, (2, 64), generator=g, device=dev)
    stacked = tokens.view(2, 4, 16).transpose(0, 1).contiguous()
    before = attention.launches
    sp = tr.transformer_forward(cfg, params, stacked, sp_axis="sp")
    torch.cuda.synchronize()
    assert attention.launches == before + cfg.n_layers
    single = tr.transformer_forward(cfg, params, tokens)
    torch.testing.assert_close(sp.transpose(0, 1).reshape(single.shape), single,
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,n,bh,t,d", [
    (torch.bfloat16, 4, 8, 256, 64),     # the sm90 route, the flagship's t and d
    (torch.bfloat16, 2, 3, 72, 40),
    (torch.float32, 4, 4, 64, 32),       # the fma route
])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_autograd_through_the_kernel_on_card(dtype, n, bh, t, d,
                                                            causal):
    """Gradients through the kernel's forward against the same backward
    on the plain version's output: the two differ only through O (in
    rowsum(dO * O)), so the bound is that of the forward, carried by
    |dO| d into dS, with the backward's own bfloat16 roundings of P and dS
    (2^-8 each) on top: 2^-5 of the gradient's largest magnitude in
    bfloat16, 1e-4 in float32."""
    from tpu_mpi_torch.kernels import attention
    from tpu_mpi_torch.parallel import ring
    dev = _card()
    q, k, v = _attention_case(dev, n, bh, t, d, dtype, 7 * t + d)
    g = torch.Generator(device=dev)
    g.manual_seed(t)
    dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = dict(attention.route_launches)
    out = ring._RingAttention.apply(*leaves, causal, d ** -0.5)
    out.backward(dout)
    torch.cuda.synchronize()
    way = attention.route(dtype, d, True)
    assert attention.route_launches[way] == before[way] + 1
    plain = attention.ring_attention_plain(q, k, v, causal=causal, scale=d ** -0.5)
    want = attention.attention_backward(q, k, v, plain, dout, causal=causal,
                                        scale=d ** -0.5)
    rel = 2.0 ** -5 if dtype == torch.bfloat16 else 1e-4
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == dtype and leaf.grad.shape == w.shape
        err = float((leaf.grad.float() - w.float()).abs().max())
        assert err <= rel * float(w.float().abs().max()), (err, float(w.abs().max()))


@pytest.mark.cuda
def test_sp_train_step_on_card():
    """One float32 sp train step on the card (fma attention, folds on the
    kernel) against the same step on the CPU."""
    from tpu_mpi_torch import collective, xla
    from tpu_mpi_torch.kernels import attention
    from tpu_mpi_torch.models import transformer as tr
    from tpu_mpi_torch.parallel import dp
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tr.TransformerConfig(vocab=64, d_model=64, n_heads=4, n_layers=2,
                               d_ff=128)
    params = tr.transformer_init(torch.Generator().manual_seed(3), cfg, device="cpu")
    tokens = torch.randint(0, 64, (2, 64), generator=torch.Generator().manual_seed(4))
    labels = tokens.roll(-1, 1)
    step, _ = tr.transformer_train_step(cfg, xla.make_mesh({"sp": 4}))
    cpu_step, _ = tr.transformer_train_step(
        cfg, xla.make_mesh({"sp": 4}, devices=[torch.device("cpu")]))
    folds, attn, chained = fr.launches, attention.launches, collective.chained_folds
    on_card = dp.tree_map(lambda p: p.to(dev), params)
    new, loss = step(on_card, tokens.to(dev), labels.to(dev))
    torch.cuda.synchronize()
    assert fr.launches - folds == 2 + 6 * cfg.n_layers + 1
    assert attention.launches - attn == cfg.n_layers
    assert collective.chained_folds == chained
    want, want_loss = cpu_step(params, tokens, labels)
    assert abs(float(loss) - float(want_loss)) <= 1e-4
    for got, w in zip(dp.leaves(new), dp.leaves(want)):
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), w, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_ddp_fsdp_on_card():
    """DDP (overlap and control) and FSDP on 4 rank threads with float64
    masters on the card: bitwise equal, every bucket folded by the kernel."""
    import numpy as np
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import collective
    from tpu_mpi_torch.train import DDPTrainer, FSDPTrainer, GradBucketer
    dev = _card()
    spec = {f"p{i}": np.random.default_rng(i).standard_normal(n)
            for i, n in enumerate((3000, 50, 4000, 120))}

    def body():
        comm = MPI.COMM_WORLD
        trainers = [DDPTrainer(spec, comm, bucket_bytes=8192),
                    DDPTrainer(spec, comm, bucket_bytes=8192, overlap=False),
                    FSDPTrainer(spec, comm)]
        for s in range(3):
            rng = np.random.default_rng(100 * s + comm.rank())
            grads = {n: torch.from_numpy(rng.standard_normal(a.size)).float()
                     for n, a in spec.items()}
            for tr in trainers:
                tr.step((n, grads[n].to(dev)) for n in reversed(list(spec)))
        torch.cuda.synchronize()
        return [{n: p.cpu() for n, p in tr.params.items()} for tr in trainers]

    folds, chained = fr.launches, collective.chained_folds
    outs = MPI.spmd_run(body, 4, timeout=300)
    nbuckets = len(GradBucketer([(n, a.size) for n, a in reversed(spec.items())],
                                8192, device=dev))
    assert fr.launches - folds >= 2 * 3 * nbuckets + 3
    assert collective.chained_folds == chained
    for rank_out in outs:
        for other in rank_out[1:]:
            for n in spec:
                assert torch.equal(rank_out[0][n].view(torch.int64),
                                   other[n].view(torch.int64)), n


# ---------------------------------------------------------------------------
# Point-to-point and Cartesian topology on CUDA tensors
# ---------------------------------------------------------------------------

def _p2p_ring(dev, wrap, n=4, count=4099):
    """A ring Sendrecv of ``wrap``-ped CUDA tensors on n rank threads; each
    rank returns what it sent, what it received and the two tensors."""
    import numpy as np
    import tpu_mpi_torch as MPI
    data = [np.random.default_rng(r).standard_normal(count).astype(np.float32)
            for r in range(n)]

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        x = wrap(torch.from_numpy(data[r]).to(dev))
        y = wrap(torch.zeros(count, device=dev))
        MPI.Sendrecv(x, (r + 1) % n, 0, y, (r - 1) % n, 0, comm)
        xt = x.value if isinstance(x, MPI.DeviceBuffer) else x
        yt = y.value if isinstance(y, MPI.DeviceBuffer) else y
        MPI.Finalize()
        return x, y, xt, yt

    return data, MPI.spmd_run(body, n, timeout=120)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tensor", "devicebuffer"])
def test_sendrecv_ring_on_card(kind):
    """Raw tensors arrive as private copies on the card; DeviceBuffers
    share the sender's tensor under copy-on-write, and a later write through
    the sender's cell does not reach the receiver."""
    import numpy as np
    import tpu_mpi_torch as MPI
    dev = _card()
    wrap = (lambda t: t) if kind == "tensor" else \
        (lambda t: MPI.DeviceBuffer(t, device=dev))
    data, res = _p2p_ring(dev, wrap)
    n = len(res)
    sent = {xt.untyped_storage().data_ptr() for _, _, xt, _ in res}
    for r, (_, _, _, yt) in enumerate(res):
        assert yt.device.type == "cuda"
        assert np.array_equal(yt.cpu().numpy(), data[(r - 1) % n])
        if kind == "tensor":
            assert yt.untyped_storage().data_ptr() not in sent
        else:
            assert yt is res[(r - 1) % n][2]
    for x, _, _, _ in res:
        if kind == "tensor":
            x.fill_(3.0)
        else:
            x.fill(3.0)
    torch.cuda.synchronize()
    for r, (_, y, _, _) in enumerate(res):
        got = y if kind == "tensor" else y.value
        assert np.array_equal(got.cpu().numpy(), data[(r - 1) % n])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tensor", "devicebuffer"])
def test_partitioned_exchange_on_card(kind):
    """8 partitions, each filled and marked ready in turn, land on the card
    bitwise; a strided raw tensor is refused before any partition moves."""
    import tpu_mpi_torch as MPI
    dev = _card()
    parts, plen = 8, 1025
    want = torch.randn(parts * plen, generator=torch.Generator().manual_seed(8))

    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        out = None
        if MPI.Comm_rank(comm) == 0:
            src = torch.zeros(parts * plen, device=dev)
            buf = src if kind == "tensor" else MPI.DeviceBuffer(src, device=dev)
            req = MPI.Psend_init(buf, parts, 1, 5, comm)
            MPI.Start(req)
            for i in range(parts):
                sl = slice(i * plen, (i + 1) * plen)
                if kind == "tensor":
                    src[sl] = want[sl].to(dev)
                else:
                    buf[sl] = want[sl].to(dev)
                MPI.Pready(req, i)
            MPI.Wait(req)
        else:
            dst = torch.zeros(parts * plen, device=dev)
            buf = dst if kind == "tensor" else MPI.DeviceBuffer(dst, device=dev)
            with pytest.raises(MPI.MPIError, match="contiguous"):
                MPI.Precv_init(torch.zeros(parts * plen, 2, device=dev)[:, 0],
                               parts, 0, 5, comm)
            req = MPI.Precv_init(buf, parts, 0, 5, comm)
            MPI.Start(req)
            MPI.Wait(req)
            out = (dst if kind == "tensor" else buf.value)
        MPI.Finalize()
        return out

    got = MPI.spmd_run(body, 2, timeout=120)[1]
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_jacobi_halo_loop_on_card():
    """The Jacobi halo loop on 4 rank threads over a 1-d Cart, slabs on the
    card: the gathered grid and every sweep's residual bitwise equal to the
    same sweeps on the whole grid in one thread; one fold launch a sweep."""
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import collective
    dev = _card()
    n, size, sweeps = 512, 4, 20
    rows = n // size

    def sweep(u, m):
        new = u[1:m + 1].clone()
        new[:, 1:-1] = 0.25 * (u[:m, 1:-1] + u[2:, 1:-1]
                               + u[1:m + 1, :-2] + u[1:m + 1, 2:])
        return new, (new - u[1:m + 1]).abs().max().reshape(1)

    def body():
        MPI.Init()
        cart = MPI.Cart_create(MPI.COMM_WORLD, 1, [size], [False], False)
        up, down = MPI.Cart_shift(cart, 0, 1)
        u = torch.zeros(rows + 2, n, device=dev)
        if MPI.Comm_rank(cart) == 0:
            u[0] = 1.0
        res = []
        for _ in range(sweeps):
            MPI.Sendrecv(u[1], up, 0, u[rows + 1], down, 0, cart)
            MPI.Sendrecv(u[rows], down, 1, u[0], up, 1, cart)
            new, local = sweep(u, rows)
            u[1:rows + 1] = new
            res.append(MPI.Allreduce(local, MPI.MAX, cart))
        MPI.Finalize()
        return u[1:rows + 1], torch.cat(res)

    folds, chained = fr.launches, collective.chained_folds
    out = MPI.spmd_run(body, size, timeout=120)
    assert fr.launches - folds == sweeps
    assert collective.chained_folds == chained
    grid = torch.zeros(n + 2, n, device=dev)
    grid[0] = 1.0
    want = []
    for _ in range(sweeps):
        new, r = sweep(grid, n)
        grid[1:n + 1] = new
        want.append(r)
    got = torch.cat([u for u, _ in out])
    assert got.device.type == "cuda"
    assert torch.equal(got, grid[1:n + 1])
    for _, res in out:
        assert torch.equal(res, torch.cat(want))


# ---------------------------------------------------------------------------
# One-sided RMA and MPI-IO on CUDA tensors
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tensor", "devicebuffer"])
def test_accumulate_folds_on_card(kind):
    """Each CUDA Accumulate and Fetch_and_op is one fold launch, the old
    values first, bitwise against the plain fold; none chained."""
    import numpy as np
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import collective
    dev = _card()
    rng = np.random.default_rng(3)
    start = torch.from_numpy(rng.standard_normal(5000).astype(np.float32)).to(dev)
    origins = [torch.from_numpy(rng.standard_normal(5000).astype(np.float32)).to(dev)
               for _ in range(4)]
    wrap = (lambda t: t) if kind == "tensor" else MPI.DeviceBuffer

    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        buf = wrap(start.clone())
        counter = wrap(torch.zeros(1, dtype=torch.int64, device=dev))
        win, cwin = MPI.Win_create(buf, comm), MPI.Win_create(counter, comm)
        MPI.Win_fence(0, win)
        for o in range(4):
            if o == r:
                MPI.Accumulate(origins[o], 5000, 0, 0, MPI.SUM, win)
            MPI.Win_fence(0, win)
        got = torch.zeros(1, dtype=torch.int64, device=dev)
        one = torch.ones(1, dtype=torch.int64, device=dev)
        for _ in range(10):
            MPI.Win_lock(MPI.LOCK_EXCLUSIVE, 0, 0, cwin)
            MPI.Fetch_and_op(one, got, 0, 0, MPI.SUM, cwin)
            MPI.Win_unlock(0, cwin)
        MPI.Win_fence(0, cwin)
        out = (buf.value if kind == "devicebuffer" else buf).clone()
        cnt = (counter.value if kind == "devicebuffer" else counter).item()
        win.free()
        cwin.free()
        return out, cnt

    folds, chained = fr.launches, collective.chained_folds
    outs = MPI.spmd_run(body, 4, timeout=120)
    assert fr.launches - folds == 4 + 40
    assert collective.chained_folds == chained
    want = fr.fused_multi_reduce_plain([start] + origins, "SUM")
    assert outs[0][0].is_cuda and torch.equal(outs[0][0], want)
    assert outs[0][1] == 40


@pytest.mark.cuda
def test_overlapping_origin_rma_on_card():
    """On a raw CUDA tensor window, each rank's own: an Accumulate SUM,
    Get_accumulate REPLACE, Put and Get whose origin views the window's
    first 5000 elements and whose target starts at displacement 2 (Get:
    the origin at 2, read from 0). Each window is bitwise the plain
    computation on a copy, which reads the source in full first; the one
    Accumulate is one fold launch, none chained."""
    import numpy as np
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import collective
    dev = _card()
    B, lo, hi = 5000, 2, 5002
    rng = np.random.default_rng(4)
    starts = [torch.from_numpy(rng.standard_normal(2 * B).astype(np.float32)).to(dev)
              for _ in range(2)]

    def plain(x, what):
        if what == "acc":
            x[lo:hi] = fr.fused_multi_reduce_plain([x[lo:hi].clone(), x[:B].clone()],
                                                   "SUM")
        elif what == "gacc":
            x[B:] = x[lo:hi].clone()
            x[lo:hi] = x[:B].clone()
        else:
            x[lo:hi] = x[:B].clone()

    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        w = starts[r].clone()
        win = MPI.Win_create(w, comm)
        calls = {
            "acc": lambda: MPI.Accumulate(w[:B], B, r, lo, MPI.SUM, win),
            "gacc": lambda: MPI.Get_accumulate(w[:B], w[B:], B, r, lo, MPI.REPLACE,
                                               win),
            "put": lambda: MPI.Put(w[:B], B, r, lo, win),
            "get": lambda: MPI.Get(w[lo:hi], B, r, 0, win),
        }
        MPI.Win_fence(0, win)
        wrong = []
        for what, call in calls.items():
            want = w.clone()
            plain(want, what)
            call()
            MPI.Win_fence(0, win)
            if not _same_bits(w, want):
                wrong.append(what)
        win.free()
        return wrong

    folds, chained = fr.launches, collective.chained_folds
    outs = MPI.spmd_run(body, 2, timeout=120)
    assert outs == [[], []]
    assert fr.launches - folds == 2 and collective.chained_folds == chained


@pytest.mark.cuda
def test_dynamic_window_on_card_tensors():
    """Get_address of a CUDA raw tensor is its data_ptr, and a dynamic
    window resolves it (test_fetch_and_op_dynamic on the card)."""
    import tpu_mpi_torch as MPI
    dev = _card()

    def body():
        comm = MPI.COMM_WORLD
        rank, n = MPI.Comm_rank(comm), MPI.Comm_size(comm)
        buf = torch.full((n,), rank, dtype=torch.int64, device=dev)
        assert MPI.Get_address(buf) == buf.data_ptr()
        win = MPI.Win_create_dynamic(comm)
        MPI.Win_attach(win, buf)
        addrs = MPI.Allgather(torch.tensor([MPI.Get_address(buf)]), comm)
        MPI.Win_fence(0, win)
        if rank == 0:
            got = torch.zeros(1, dtype=torch.int64, device=dev)
            for r in range(n):
                MPI.Win_lock(MPI.LOCK_EXCLUSIVE, r, 0, win)
                MPI.Fetch_and_op(torch.tensor([r + 5], device=dev), got, r,
                                 int(addrs[r]) + 8 * r, MPI.REPLACE, win)
                MPI.Win_unlock(r, win)
                assert got.item() == r
        MPI.Win_fence(0, win)
        assert buf[rank].item() == rank + 5
        MPI.Win_detach(win, buf)
        win.free()

    MPI.spmd_run(body, 4, timeout=120)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["tensor", "devicebuffer"])
def test_read_at_all_into_card_tensors(kind, tmp_path):
    """write_at_all of CUDA tensors and read_at_all back into fresh CUDA
    tensors, bitwise; a raw tensor is filled in place."""
    import numpy as np
    import tpu_mpi_torch as MPI
    dev = _card()
    path = str(tmp_path / "f.bin")
    data = [torch.from_numpy(np.random.default_rng(r).standard_normal(4097)
                             .astype(np.float32)).to(dev) for r in range(4)]
    wrap = (lambda t: t) if kind == "tensor" else MPI.DeviceBuffer

    def body():
        comm = MPI.COMM_WORLD
        r = MPI.Comm_rank(comm)
        fh = MPI.File.open(comm, path, read=True, write=True, create=True)
        try:
            MPI.File.set_view(fh, 0, MPI.FLOAT32, MPI.FLOAT32)
            MPI.File.write_at_all(fh, r * 4097, wrap(data[r]))
            back = wrap(torch.zeros(4097, device=dev))
            ptr = MPI.Get_address(back)
            MPI.File.read_at_all(fh, ((r + 1) % 4) * 4097, back)
            t = back.value if kind == "devicebuffer" else back
            assert t.is_cuda and torch.equal(t, data[(r + 1) % 4])
            return MPI.Get_address(back) == ptr
        finally:
            fh.close()

    in_place = MPI.spmd_run(body, 4, timeout=120)
    assert in_place == [kind == "tensor"] * 4


# ---------------------------------------------------------------------------
# Unsigned folds (uint16, uint32, uint64) through the kernels
# ---------------------------------------------------------------------------

_UNSIGNED = [torch.uint16, torch.uint32, torch.uint64]
_KERNEL_OPS = ("SUM", "PROD", "MAX", "MIN", "BAND", "BOR", "BXOR")


def _mixed(dtype, n, count, dev, seed):
    """Floats at mixed magnitudes (the ring order shows in the bits), or
    random bits of an integer type."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    if dtype.is_floating_point:      # float16 sums stay finite
        top = 3 if dtype == torch.float16 else 5
        mag = 10.0 ** torch.randint(-4, top, (n, count), generator=g, device=dev)
        return (torch.randn(n, count, generator=g, device=dev) * mag).to(dtype)
    if dtype == torch.bool:
        return torch.randint(0, 2, (n, count), generator=g, device=dev).bool()
    size = torch.empty((), dtype=dtype).element_size()
    return torch.randint(0, 256, (n, count * size), generator=g, device=dev,
                         dtype=torch.uint8).view(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _UNSIGNED)
def test_unsigned_kernels_match_plain_on_card(dtype):
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch.kernels import ring
    dev = _card()
    xs = _mixed(dtype, 5, 4097, dev, 21)               # random bits: they wrap
    blocks = _mixed(dtype, 4, 4 * 2048, dev, 22)        # the staged route
    odd = _mixed(dtype, 5, 5 * 1031, dev, 23)           # the direct route
    for name in _KERNEL_OPS:
        assert fr.supports(name, dtype)
        op = getattr(MPI, name)
        combine = ring._combine_fn(op)[1]
        folds, rings = fr.launches, dict(ring.launches)
        pairs = [(fr.fused_multi_reduce(list(xs), name),
                  fr.fused_multi_reduce_plain(list(xs), name)),
                 (ring.ring_allreduce(xs, op), ring.ring_allreduce_plain(xs, combine))]
        pairs += [(ring.ring_reduce_scatter(b, op),
                   ring.ring_reduce_scatter_plain(b, combine)) for b in (blocks, odd)]
        torch.cuda.synchronize()
        assert fr.launches == folds + 1
        assert ring.launches["ring_allreduce"] == rings["ring_allreduce"] + 1
        assert ring.launches["ring_reduce_scatter"] == rings["ring_reduce_scatter"] + 2
        for got, want in pairs:
            assert got.dtype == dtype and torch.equal(got, want), (dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _UNSIGNED)
def test_unsigned_allreduce_on_card(dtype):
    """MPI.Allreduce of CUDA DeviceBuffers folds in the kernel, bitwise
    the numpy fold; xla.allreduce's logical ops fold ``x != 0``."""
    import functools
    import numpy as np
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import collective, xla
    _card()
    rng = np.random.default_rng(24)
    npd = np.dtype(str(dtype).split(".")[1])
    data = [rng.integers(0, np.iinfo(npd).max, 3001, dtype=npd, endpoint=True)
            for _ in range(4)]
    want = {name: functools.reduce(ufunc, data) for name, ufunc in
            (("SUM", np.add), ("MAX", np.maximum), ("MIN", np.minimum))}
    folds, chained = fr.launches, collective.chained_folds

    def body():
        comm = MPI.COMM_WORLD
        x = MPI.DeviceBuffer(data[MPI.Comm_rank(comm)])
        return {name: MPI.Allreduce(x, getattr(MPI, name), comm).value.cpu().numpy()
                for name in want}

    for got in MPI.spmd_run(body, 4, timeout=120):
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
    assert fr.launches >= folds + 3 and collective.chained_folds == chained
    mesh = xla.make_mesh({"x": 4})
    xs = torch.from_numpy(np.stack(data)).to(mesh.device)
    xs[0, :7] = 0
    land = xla.allreduce(xs, MPI.LAND)
    torch.cuda.synchronize()
    assert land.dtype == dtype
    np.testing.assert_array_equal(
        land[0].cpu().numpy(), np.logical_and.reduce(np.stack(data) != 0, 0)
        .astype(npd) * (np.arange(3001) >= 7))


# ---------------------------------------------------------------------------
# The reduce-scatter kernel's routes: staged (bulk asynchronous copies into
# a ring of shared-memory stages) and direct
# ---------------------------------------------------------------------------

def _reduce_scatter_case(xs):
    """One kernel call against the plain ring fold, bitwise, and its count."""
    from tpu_mpi_torch.kernels import ring
    before = ring.launches["ring_reduce_scatter"]
    got = ring.ring_reduce_scatter(xs, "sum")
    want = ring.ring_reduce_scatter_plain(xs, ring._combine_fn("sum")[1])
    torch.cuda.synchronize()
    assert ring.launches["ring_reduce_scatter"] == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype.is_floating_point:     # bits, so -0.0 and 0.0 differ
        got, want = got.view(_INT_OF[got.element_size()]), \
            want.view(_INT_OF[want.element_size()])
    assert torch.equal(got, want)


_INT_OF = {2: torch.int16, 4: torch.int32, 8: torch.int64}


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(2, torch.float32), (4, torch.float32),
                                     (5, torch.bfloat16), (8, torch.float64),
                                     (4, torch.int8), (5, torch.uint32),
                                     (4, torch.bool)])
def test_reduce_scatter_sizes_around_a_tile_on_card(n, dtype):
    """Blocks of tile - 1, tile and tile + 1 elements (whole 16-byte words
    or not) and of tile +- one word, so the last tile of a block is short,
    full, or one word or element long."""
    from tpu_mpi_torch.kernels import ring
    dev = _card()
    tile = ring.staged_tile(n, dtype)
    word = 16 // torch.empty((), dtype=dtype).element_size()
    assert tile > 0 and tile % word == 0
    for per in (tile - 1, tile, tile + 1, tile - word, tile + word, 3 * tile + word):
        _reduce_scatter_case(_mixed(dtype, n, n * per, dev, per))


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [(2, torch.float32), (5, torch.float16),
                                     (8, torch.float64)])
def test_reduce_scatter_many_tiles_on_card(n, dtype):
    """Far more tiles than CTAs resident at once (more than 24 a streaming
    multiprocessor), so every SM takes tile after tile, and a short last
    tile in every block."""
    from tpu_mpi_torch.kernels import ring
    dev = _card()
    tile = ring.staged_tile(n, dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per = (24 * sms // n + 1) * tile + 16
    _reduce_scatter_case(_mixed(dtype, n, n * per, dev, 31))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.int16])
def test_reduce_scatter_unaligned_base_on_card(dtype):
    """A base one element past a 16-byte boundary takes the direct route."""
    dev = _card()
    n, per = 4, 8192
    flat = _mixed(dtype, 1, n * n * per + 1, dev, 41).reshape(-1)
    xs = flat[1:].view(n, n * per)
    assert xs.data_ptr() % 16 != 0
    _reduce_scatter_case(xs)


@pytest.mark.cuda
def test_reduce_scatter_many_ranks_take_the_direct_route_on_card():
    from tpu_mpi_torch.kernels import ring
    dev = _card()
    assert ring.staged_tile(64, torch.float32) == 0
    _reduce_scatter_case(_mixed(torch.float32, 64, 64 * 1024, dev, 51))
    assert ring.staged_tile(24, torch.float32) > 0
    _reduce_scatter_case(_mixed(torch.float32, 24, 24 * 4096, dev, 52))


# ---------------------------------------------------------------------------
# Meshes of several axes: one launch a grouped collective, the autograd
# permute and all-to-all, grouped ring attention
# ---------------------------------------------------------------------------

MESH3 = {"dp": 2, "tp": 2, "sp": 2}


@pytest.mark.cuda
@pytest.mark.parametrize("axis", ["dp", "sp", ("dp", "sp"), ("sp", "tp", "dp")])
def test_grouped_collectives_launch_once_on_card(axis):
    from tpu_mpi_torch import xla
    from tpu_mpi_torch.kernels import permute, ring
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    x = torch.randn(2, 2, 2, 8, 1000, generator=g, device=dev)
    n = 2 if isinstance(axis, str) else 2 ** len(axis)
    dest = [i + 1 if i + 1 < n else None for i in range(n)]
    calls = {
        "allreduce": (lambda t: xla.allreduce(t, axis=axis, mesh=MESH3),
                      lambda: fr.launches),
        "allgather": (lambda t: xla.allgather(t, axis=axis, mesh=MESH3),
                      lambda: ring.launches["ring_allgather"]),
        "alltoall": (lambda t: xla.alltoall(t, axis=axis, mesh=MESH3, split_axis=0,
                                            concat_axis=1),
                     lambda: permute.launches["pairwise_alltoall"]),
        "ring_shift": (lambda t: xla.ring_shift(t, axis=axis, mesh=MESH3),
                       lambda: permute.launches["collective_permute"]),
        "sendrecv": (lambda t: xla.sendrecv(t, dest=dest, axis=axis, mesh=MESH3),
                     lambda: permute.launches["collective_permute"]),
    }
    for name, (fn, count) in calls.items():
        before = count()
        got = fn(x)
        torch.cuda.synchronize()
        assert count() == before + 1, name
        assert torch.equal(got.cpu(), fn(x.cpu())), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_permute_and_alltoall_match_plain_autograd_on_card(dtype):
    from tpu_mpi_torch import xla
    from tpu_mpi_torch.kernels import permute
    from tpu_mpi_torch.xla import collectives as xc
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(10)
    x = torch.randn(2, 2, 2, 8, 500, generator=g, device=dev).to(dtype)

    def plain_sendrecv(t):
        group = xc._Group(t, "tp", MESH3, "sendrecv")
        rows = group.rows(t)
        return group.back(torch.stack([torch.zeros_like(rows[0]), rows[0]]))

    cases = {
        "ring_shift": (lambda t: xla.ring_shift(t, axis="sp", mesh=MESH3),
                       lambda t: t.roll(1, 2), "collective_permute"),
        "sendrecv": (lambda t: xla.sendrecv(t, dest=[1, None], axis="tp", mesh=MESH3),
                     plain_sendrecv, "collective_permute"),
        "alltoall": (lambda t: xla.alltoall(t, axis="dp", mesh=MESH3, split_axis=0,
                                            concat_axis=1),
                     lambda t: xc._Group(t, "dp", MESH3, "a").back(xc._alltoall_plain(
                         xc._Group(t, "dp", MESH3, "a").rows(t), 0, 1, True)),
                     "pairwise_alltoall"),
    }
    for name, (kernel, plain, counter) in cases.items():
        a = x.clone().requires_grad_()
        before = permute.launches[counter]
        ya = kernel(a)
        cot = torch.randn(ya.shape, generator=g, device=dev).to(dtype)
        ya.backward(cot)
        torch.cuda.synchronize()
        assert permute.launches[counter] == before + 2, name     # forward, backward
        b = x.clone().requires_grad_()
        yb = plain(b)
        yb.backward(cot)
        assert torch.equal(ya, yb) and torch.equal(a.grad, b.grad), name


@pytest.mark.cuda
def test_ring_attention_over_a_sub_axis_is_one_sm90_launch_on_card():
    from tpu_mpi_torch import parallel as tpar
    from tpu_mpi_torch.kernels import attention
    dev = _card()
    g = torch.Generator(device=dev)
    g.manual_seed(11)
    q, k, v = (torch.randn(2, 2, 2, 2, 4, 128, 64, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    before, sm90 = attention.launches, attention.route_launches["sm90"]
    got = tpar.ring_attention(q, k, v, axis="sp", mesh=MESH3)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    assert attention.route_launches["sm90"] == sm90 + 1
    flat = [x.movedim(2, 0).reshape(2, -1, 128, 64).contiguous() for x in (q, k, v)]
    want = attention.ring_attention_plain(*flat, causal=True, scale=64 ** -0.5)
    bound = attention.allowed_error(*flat, want, causal=True, scale=64 ** -0.5)
    err = (got.movedim(2, 0).reshape(want.shape).float() - want.float()).abs()
    assert bool((err <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("red", ["sum", "prod", "min", "max"])
def test_serve_broker_on_card_replies_the_rank_ordered_fold(red):
    """A ``device="cuda"`` broker answers an Allreduce in one fold-kernel
    launch per op, with the bits of the JAX broker's reply (numpy's
    rank-ordered left fold on the host) at every position: a SUM or PROD
    that meets a NaN keeps the operand's payload, and MAX/MIN of zeros of
    both signs return the second operand, as numpy does (the fold
    kernel's NUMPY_* steps)."""
    import numpy as np
    from tpu_mpi_torch import collective, serve
    _card()
    rng = np.random.default_rng(17)
    parts = [rng.standard_normal(4099).astype(np.float32) for _ in range(4)]
    for i, p in enumerate(parts):
        if i == 1:
            p[:1] = np.array([0x7FC01234], np.uint32).view(np.float32)
        p[1:3] = [-0.0, 0.0] if i % 2 == 0 else [0.0, -0.0]
    fold = {"sum": np.add, "prod": np.multiply, "min": np.minimum,
            "max": np.maximum}[red]
    want = parts[0]                 # the JAX broker's fold
    for p in parts[1:]:
        want = fold(want, p)
    b = serve.Broker(nranks=4, token="tk")
    b.run_in_thread()
    try:
        assert str(b.pool.device).startswith("cuda")
        with serve.attach(b.address, tenant="card", token="tk") as s:
            before, chained = fr.launches, collective.chained_folds
            got = s.allreduce(parts, op=red)
            assert fr.launches == before + 1
            assert collective.chained_folds == chained
    finally:
        b.close()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float16", "float32", "float64"])
def test_numpy_rule_kernel_matches_numpy_and_plain_on_card(dtype):
    """The fold kernel's NUMPY_* steps against numpy's own fold and the
    plain version, over every pair of NaNs (quiet, signalling, both
    signs), infinities, signed zeros and numbers, at the lengths of
    numpy's scalar and vectorised loops. Where both operands of a SUM or
    PROD are NaN, numpy's vectorised float32/float64 loops pick either
    NaN by host; those positions are held to numpy's scalar loop, whose
    pick the kernel takes (``tests/numpy_rules_cases.py``)."""
    from numpy_rules_cases import (NUMPY_OPS, numpy_fold_bits, pair_cases,
                                   uint_of)
    dev = _card()
    u = uint_of(dtype)
    for length in (1, 7, 8, 17, 4099):
        for op, ufunc in NUMPY_OPS.items():
            for a, b in pair_cases(dtype, length):
                want = numpy_fold_bits(ufunc, a, b)
                ta, tb = (torch.from_numpy(x).to(dev) for x in (a, b))
                before = fr.launches
                got = fr.fused_multi_reduce([ta, tb], op)
                plain = fr.fused_multi_reduce_plain([ta, tb], op)
                torch.cuda.synchronize()
                assert fr.launches == before + 1
                assert (got.cpu().numpy().view(u) == want).all(), (op, length)
                assert (plain.cpu().numpy().view(u) == want).all(), (op, length)


def _infer_streams(serve, b, prompts, max_new, stagger=0.0, prefix="c"):
    import threading
    import time
    outs, errs = [None] * len(prompts), []

    def worker(i):
        try:
            time.sleep(stagger * i)
            with serve.attach(b.address, tenant=f"{prefix}{i}",
                              token="tk") as s:
                outs[i] = s.generate(prompts[i], max_new=max_new)
        except BaseException as e:      # noqa: BLE001 - reported below
            errs.append(e)
    ts = [threading.Thread(target=worker, args=(i,))
          for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert not errs, errs
    return outs


_INFER_PROMPTS = [[3, 1, 4, 1, 5, 9, 2, 6, 11, 12], [3, 1, 4, 1, 5, 9, 2, 6, 21],
                  list(range(7, 27)), [50, 51, 52]]


@pytest.mark.cuda
def test_infer_engine_lanes_bitwise_on_card():
    """The engine on the card at a small width: every decode lane (row
    loop, vectorized, speculative, prefix sharing, chunked prefill) emits
    the row loop's streams bit for bit, batched or staggered — each row's
    products keep one shape whatever shares its batch."""
    from tpu_mpi_torch import collective, serve
    _card()
    modes = [{"vectorized": False, "spec_k": 1, "prefix_share": False},
             {"vectorized": True}, {"vectorized": True, "spec_k": 6},
             {"vectorized": True, "spec_k": 6, "prefix_share": True},
             {"vectorized": True, "prefill_chunk": 8}]
    per_mode = []
    chained = collective.chained_folds
    for mode in modes:
        b = serve.Broker(nranks=4, token="tk", infer=dict(mode))
        b.run_in_thread()
        try:
            eng = b.infer_engine
            assert all(st["kv"].k.is_cuda and all(
                t.is_cuda for t in st["sp"].values())
                for st in eng._state.values())
            outs = _infer_streams(serve, b, _INFER_PROMPTS, 10)
            assert _infer_streams(serve, b, _INFER_PROMPTS, 10, stagger=0.03,
                                  prefix="s") == outs, mode
        finally:
            b.close()
        per_mode.append(outs)
    assert all(o == per_mode[0] for o in per_mode[1:])
    assert collective.chained_folds == chained


@pytest.mark.cuda
def test_infer_engine_on_card_matches_the_cpu_engine():
    """The same seeded weights on the card and on the CPU: equal greedy
    streams, every sampled row's final-row logits within 1e-4."""
    import numpy as np
    from tpu_mpi_torch import serve
    _card()
    runs = {}
    for dev in ("cuda", "cpu"):
        b = serve.Broker(nranks=4, token="tk", infer={"seed": 3}, device=dev)
        b.run_in_thread()
        try:
            b.infer_engine.logit_log = {}
            with serve.attach(b.address, tenant="cmp", token="tk") as s:
                outs = [s.generate(p, max_new=10) for p in _INFER_PROMPTS]
            log = b.infer_engine.logit_log
            runs[dev] = (outs, np.stack([r for rid in sorted(log)
                                         for r in log[rid]]))
        finally:
            b.close()
    assert runs["cuda"][0] == runs["cpu"][0]
    assert np.abs(runs["cuda"][1] - runs["cpu"][1]).max() <= 1e-4


@pytest.mark.cuda
def test_elastic_resize_with_the_engine_live_on_card():
    """A restore resize on a card pool with the engine live: the verdict
    for rank 3 lands at an engine step boundary mid-generation, the
    replacement rank stages on the card, the engine's tensors move with
    the slot, the generation streams as undisturbed, and a tenant's
    replies stay bitwise with one fold launch an op."""
    import os
    import threading
    import time
    import numpy as np
    from tpu_mpi_torch import config, serve
    _card()
    prompt = list(range(3, 17))
    os.environ.update(TPU_MPI_ELASTIC_INTERVAL_MS="3600000",
                      TPU_MPI_ELASTIC_COOLDOWN_MS="0")
    config.load(refresh=True)
    try:
        b = serve.Broker(nranks=4, token="tk", infer=True, elastic=True)
        b.run_in_thread()
    finally:
        os.environ.pop("TPU_MPI_ELASTIC_INTERVAL_MS")
        os.environ.pop("TPU_MPI_ELASTIC_COOLDOWN_MS")
        config.load(refresh=True)
    try:
        with serve.attach(b.address, tenant="calm", token="tk") as s:
            want = s.generate(prompt, max_new=40)
        eng = b.infer_engine
        ptr = eng._state[3]["sp"]["w_in"].data_ptr()
        out, streamed, started = {}, [], threading.Event()

        def on_token(t):
            streamed.append(t)
            if len(streamed) >= 4:
                started.set()

        def gen():
            with serve.attach(b.address, tenant="rider", token="tk") as s:
                out["toks"] = s.generate(prompt, max_new=40,
                                         on_token=on_token)

        th = threading.Thread(target=gen)
        th.start()
        parts = [np.arange(64, dtype=np.float32) * (i + 1) for i in range(2)]
        with serve.attach(b.address, tenant="folds", token="tk",
                          nranks=2) as s:
            first = s.allreduce(parts)
            assert started.wait(60)
            assert b._infer_sched.pause(timeout=30)
            b.on_rank_failure(3)
            deadline = time.monotonic() + 60
            while b.elastic_state["resizes"] < 1 \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            assert b.elastic_state["resizes"] == 1, b.elastic_state
            before = fr.launches
            assert s.allreduce(parts).tobytes() == first.tobytes()
            assert fr.launches == before + 1
        th.join(timeout=120)
        assert out["toks"] == want == streamed
        new = eng.ranks[3]
        assert new != 3 and eng._state[new]["sp"]["w_in"].data_ptr() == ptr
        assert str(b.pool.device).startswith("cuda")
    finally:
        b.close()


def _traced_run(body, nprocs=2):
    """``body`` on rank threads with tracing on; the error's type name (or
    None) and the verifier's findings as (code, line, message)."""
    import os
    import tpu_mpi_torch as MPI
    from tpu_mpi_torch import config
    from tpu_mpi_torch.testing import run_spmd
    os.environ["TPU_MPI_TRACE"] = "1"
    config.load(refresh=True)
    err = None
    try:
        run_spmd(body, nprocs=nprocs)
    except Exception as e:          # noqa: BLE001 — defects are expected
        err = type(e).__name__
    finally:
        os.environ.pop("TPU_MPI_TRACE")
        config.load(refresh=True)
    diags = MPI.analyze.verify_trace(MPI.analyze.last_trace())
    return err, [(d.code, d.line, d.message) for d in diags]


def _isend_cuda(make, mutate):
    import tpu_mpi_torch as MPI

    def body():
        comm = MPI.COMM_WORLD
        if MPI.Comm_rank(comm) == 0:
            x = make()
            req = MPI.Isend(x, 1, 3, comm)
            if mutate:
                with torch.no_grad():
                    x[0] = 99
            MPI.Wait(req)
        else:
            out = torch.zeros(4099, dtype=make().dtype, device="cuda")
            MPI.Recv(out, 0, 3, comm)
        MPI.Barrier(comm)
    return body


_ISEND_CUDA_LINE = _isend_cuda.__code__.co_firstlineno + 7


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "requires_grad"])
def test_trace_isend_mutation_of_cuda_tensor_is_t206_on_card(kind):
    """The Isend check reads a raw CUDA tensor's bytes (one copy to the
    host at the Isend and one at its Wait): a write before the Wait is
    T206 at the Isend's line, an untouched buffer is clean."""
    _card()

    def make():
        if kind == "bfloat16":
            return torch.ones(4099, dtype=torch.bfloat16, device="cuda")
        return torch.ones(4099, device="cuda",
                          requires_grad=kind == "requires_grad")
    err, diags = _traced_run(_isend_cuda(make, True))
    assert err is None
    assert [(c, ln) for c, ln, _ in diags] == [("T206", _ISEND_CUDA_LINE)]
    assert _traced_run(_isend_cuda(make, False)) == (None, [])


@pytest.mark.cuda
def test_trace_names_cuda_dtypes_as_numpy_on_card():
    """A numpy float32 and a CUDA float32 tensor on two ranks agree (no
    T202); CUDA float32 against float64 is T202 in numpy's words."""
    import numpy as np
    import tpu_mpi_torch as MPI
    _card()

    def mixed():
        comm = MPI.COMM_WORLD
        x = np.arange(8, dtype=np.float32)
        if MPI.Comm_rank(comm) == 1:
            x = torch.from_numpy(x).cuda()
        MPI.Allreduce(x, MPI.SUM, comm)
        MPI.Bcast(x, 0, comm)
    assert _traced_run(mixed) == (None, [])

    def mismatch():
        comm = MPI.COMM_WORLD
        dt = torch.float32 if MPI.Comm_rank(comm) == 0 else torch.float64
        MPI.Bcast(torch.zeros(4, dtype=dt, device="cuda"), 0, comm)
    _, diags = _traced_run(mismatch)
    assert [(c, m) for c, _, m in diags] == [(
        "T202", "dtype disagrees across ranks in Bcast@0: ['float32', "
        "'float64'] (collective round 0 of comm 0)")]
