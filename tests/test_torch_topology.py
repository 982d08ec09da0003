"""tpu_mpi_torch's Cartesian topology against tpu_mpi's.

The programs of tests/test_topology.py (Dims_create, Cart_*, Neighbor_*)
run through both packages, as in tests/test_torch_p2p.py, and the port's
results are held to the JAX package's bitwise. Beyond them: the Jacobi
halo loop of examples/06-jacobi.py at N=64 on 4 ranks (numpy and raw CPU
tensors in the port, numpy in the JAX package), bitwise against each other
and against the same sweeps on the whole grid in one thread; and the
Cart-to-mesh bridge of the in-graph tier.

Not ported: the TPU-torus tests (test_arrange_devices_axis_match,
test_dims_create_torus_aware, test_cart_create_reorder_honors_torus,
test_cart_device_mesh_cpu's 2-d mesh): the port's ranks share the cards
of one host, so there is no torus to map a grid onto, and meshes of
several axes come later (ROADMAP Queue A #8b).
"""

import math

import numpy as np
import pytest
import torch

import tpu_mpi as JMPI
import tpu_mpi_torch as MPI
from tpu_mpi_torch import xla

from test_torch_p2p import AT, KINDS, assert_parity, host, same

CPU = torch.device("cpu")


@pytest.mark.parametrize("nnodes, dims", [
    (8, [0, 0, 0]), (6, [0, 0]), (4, [2, 0]), (7, [0]), (12, [0, 0]),
    (16, [0, 0]), (24, [0, 0, 0]), (1, [0, 0]), (6, [0, 3]), (6, [2, 3]),
    (7, [2, 0]), (6, [4, 0]), (6, [2, -1]), (6, [2, 2])])
def test_dims_create_parity(nnodes, dims):
    def call(M):
        try:
            return M.Dims_create(nnodes, list(dims))
        except M.MPIError as e:
            return ("MPIError", e.code)

    got, want = call(MPI), call(JMPI)
    assert got == want
    if not isinstance(got, tuple):
        assert math.prod(got) == nnodes


def p_cart_create_coords_rank(M, AT):
    def body():
        comm = M.COMM_WORLD
        nnodes = M.Comm_size(comm)
        dims = M.Dims_create(nnodes, [0, 0])
        cart = M.Cart_create(comm, dims, [0, 1], True)
        assert M.Comm_size(cart) == nnodes and M.Cartdim_get(cart) == 2
        rank = M.Comm_rank(cart)
        coords = M.Cart_coords(cart)
        assert all(0 <= c < d for c, d in zip(coords, dims))
        assert M.Cart_rank(cart, coords) == rank
        for r in range(nnodes):
            assert M.Cart_rank(cart, M.Cart_coords(cart, r)) == r
        gdims, gperiods, gcoords = M.Cart_get(cart)
        assert gdims == list(dims) and gperiods == [0, 1] and gcoords == coords
        M.comm.free(cart)
        return rank, coords, M.Cart_get(M.Cart_create(comm, [nnodes], [1], False))
    return body


def p_cart_shift(M, AT):
    def body():
        comm = M.COMM_WORLD
        size = M.Comm_size(comm)
        ring = M.Cart_create(comm, [size], [1], False)
        rank = M.Comm_rank(ring)
        src, dest = M.Cart_shift(ring, 0, 1)
        assert dest == (rank + 1) % size and src == (rank - 1) % size
        line = M.Cart_create(comm, [size], [0], False)
        lsrc, ldest = M.Cart_shift(line, 0, 1)
        assert ldest == (M.PROC_NULL if rank == size - 1 else rank + 1)
        assert lsrc == (M.PROC_NULL if rank == 0 else rank - 1)
        two = M.Cart_shift(ring, 0, 2)
        return (src, dest), (lsrc == M.PROC_NULL, ldest == M.PROC_NULL), two
    return body


def p_cart_sub(M, AT):
    def body():
        comm = M.COMM_WORLD
        dims = M.Dims_create(M.Comm_size(comm), [0, 0])
        cart = M.Cart_create(comm, dims, [0, 0], False)
        rows = M.Cart_sub(cart, [False, True])
        cols = M.Cart_sub(cart, [True, False])
        assert M.Comm_size(rows) == dims[1] and M.Comm_size(cols) == dims[0]
        assert M.Comm_rank(rows) == M.Cart_coords(cart)[1]
        assert M.Comm_rank(cols) == M.Cart_coords(cart)[0]
        return (rows.group, cols.group, rows.dims, cols.dims, rows.periods)
    return body


def p_cart_halo_allreduce_combo(M, AT):
    def body():
        comm = M.COMM_WORLD
        size = M.Comm_size(comm)
        dims = M.Dims_create(size, [0, 0])
        cart = M.Cart_create(comm, dims, [1, 1], False)
        rank = M.Comm_rank(cart)
        interior = AT.full(4, float(rank))
        acc = 0.0
        for d in range(2):
            src, dest = M.Cart_shift(cart, d, 1)
            halo = AT.zeros(4)
            M.Sendrecv(interior, dest, d, halo, src, d, cart)
            acc += float(host(halo)[0])
        total = M.Allreduce(acc, M.SUM, cart)
        expect = 0.0
        for r in range(size):
            coords = M.Cart_coords(cart, r)
            for d in range(2):
                nb = list(coords)
                nb[d] = (nb[d] - 1) % dims[d]
                expect += M.Cart_rank(cart, nb)
        assert total == pytest.approx(expect)
        return acc, float(np.asarray(total))
    return body


def p_neighbor_allgather_ring(M, AT):
    def body():
        comm = M.COMM_WORLD
        size = M.Comm_size(comm)
        ring = M.Cart_create(comm, [size], [1], False)
        r = M.Comm_rank(ring)
        got = host(M.Neighbor_allgather(AT.full(2, float(r)), ring))
        got = got.reshape(2, 2)
        assert got[0, 0] == (r - 1) % size and got[1, 0] == (r + 1) % size, got
        return got
    return body


def p_neighbor_alltoall_2d_boundaries(M, AT):
    def body():
        comm = M.COMM_WORLD
        dims = M.Dims_create(M.Comm_size(comm), [0, 0])
        cart = M.Cart_create(comm, dims, [0, 0], False)
        r = M.Comm_rank(cart)
        nbrs = []
        for d in range(2):
            nbrs.extend(M.Cart_shift(cart, d, 1))
        # block i carries (100*me + 10*i) so the receiver can attribute it
        send = AT.array(np.concatenate([np.full(3, 100.0 * r + 10 * i)
                                        for i in range(4)]))
        out = host(M.Neighbor_alltoall(send, 3, cart)).reshape(4, 3)
        recv = AT.full(12, -7.0)
        M.Neighbor_alltoall(send, recv, 3, cart)
        for i, nb in enumerate(nbrs):
            if nb == M.PROC_NULL:
                assert np.all(out[i] == 0), (r, i, out)
                assert np.all(host(recv)[3 * i:3 * i + 3] == -7.0)
            else:
                # neighbour nb aimed its block i^1 (the opposite direction
                # along the same dimension) at me
                assert np.all(out[i] == 100.0 * nb + 10 * (i ^ 1)), (r, i, out)
        return out, host(recv)
    return body


def p_neighbor_allgather_keeps_proc_null_slots(M, AT):
    def body():
        comm = M.COMM_WORLD
        size = M.Comm_size(comm)
        line = M.Cart_create(comm, [size], [0], False)       # non-periodic
        r = M.Comm_rank(line)
        recv = AT.full(4, -7.0)                               # boundary fill
        M.Neighbor_allgather(AT.full(2, float(r)), recv, line)
        got = host(recv).reshape(2, 2)
        assert np.all(got[0] == (-7.0 if r == 0 else r - 1)), got
        assert np.all(got[1] == (-7.0 if r == size - 1 else r + 1)), got
        return got
    return body


def p_neighbor_requires_cart(M, AT):
    def body():
        with pytest.raises(M.MPIError) as ei:
            M.Neighbor_allgather(AT.zeros(2), M.COMM_WORLD)
        with pytest.raises(M.MPIError):
            M.Neighbor_alltoall(AT.zeros(2), 1, M.COMM_WORLD)
        return ei.value.code
    return body


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("program", [
    p_cart_create_coords_rank, p_cart_shift, p_cart_sub,
    p_cart_halo_allreduce_combo, p_neighbor_allgather_ring,
    p_neighbor_alltoall_2d_boundaries,
    p_neighbor_allgather_keeps_proc_null_slots, p_neighbor_requires_cart],
    ids=lambda p: p.__name__[2:])
def test_parity(program, kind, nprocs):
    assert_parity(program, kind, nprocs)


# ---------------------------------------------------------------------------
# The Jacobi halo loop (examples/06-jacobi.py), fixed sweep count
# ---------------------------------------------------------------------------

SWEEPS = 50


def _copy(x):
    return x.clone() if isinstance(x, torch.Tensor) else x.copy()


def _absmax(d):
    """max |d| as a one-element array of d's kind."""
    return abs(d).max().reshape(1)


def sweep(u, rows):
    """One five-point update of the slab's rows 1..rows; returns the new
    rows and their largest change."""
    new = _copy(u[1:rows + 1])
    new[:, 1:-1] = 0.25 * (u[:rows, 1:-1] + u[2:, 1:-1]
                           + u[1:rows + 1, :-2] + u[1:rows + 1, 2:])
    return new, _absmax(new - u[1:rows + 1])


def p_jacobi(M, AT, n, dtype):
    def body():
        comm = M.COMM_WORLD
        rank, size = M.Comm_rank(comm), M.Comm_size(comm)
        cart = M.Cart_create(comm, 1, [size], [False], False)
        up, down = M.Cart_shift(cart, 0, 1)    # non-periodic: PROC_NULL edges
        rows = n // size + (1 if rank < n % size else 0)
        u0 = np.zeros((rows + 2, n), dtype=dtype)
        if rank == 0:
            u0[0, :] = 1.0                     # the fixed hot top edge
        u = AT.wrap(u0)
        residuals = []
        for _ in range(SWEEPS):
            M.Sendrecv(u[1], up, 0, u[rows + 1], down, 0, cart)
            M.Sendrecv(u[rows], down, 1, u[0], up, 1, cart)
            new, local = sweep(u, rows)
            u[1:rows + 1] = new
            residuals.append(host(M.Allreduce(local, M.MAX, cart)))
        return host(u[1:rows + 1]), residuals
    return body


def jacobi_whole_grid(n, dtype):
    """The same sweeps on the whole grid in one thread."""
    u = np.zeros((n + 2, n), dtype=dtype)
    u[0, :] = 1.0
    residuals = []
    for _ in range(SWEEPS):
        new, res = sweep(u, n)
        u[1:n + 1] = new
        residuals.append(res)
    return u[1:n + 1], residuals


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("n", [64, 66])
def test_jacobi_parity(n, kind, dtype):
    out = assert_parity(p_jacobi, kind, 4, n=n, dtype=dtype)
    grid, residuals = jacobi_whole_grid(n, dtype)
    assert same(np.concatenate([u for u, _ in out]), grid)
    for _, res in out:
        assert same(res, residuals)
    assert residuals[-1][0] < residuals[0][0]


# ---------------------------------------------------------------------------
# The Cart-to-mesh bridge
# ---------------------------------------------------------------------------

def test_cart_device_mesh_and_comm_mesh():
    def body():
        MPI.Init()
        comm = MPI.COMM_WORLD
        line = MPI.Cart_create(comm, [4], [1], True)       # reorder: kept
        assert line.group == comm.group
        mesh = line.device_mesh(devices=[CPU])
        via = xla.comm_mesh(line, "sp", devices=[CPU])
        grid = MPI.Cart_create(comm, [2, 2], [0, 0], False)
        square = grid.device_mesh(devices=[CPU])
        named = xla.comm_mesh(grid, devices=[CPU])
        MPI.Finalize()
        return (mesh.axis_names, mesh.size, mesh.device, via.axis_names,
                line.mesh_axes(), grid.mesh_axes(), square.shape, named.shape,
                square.device)

    res = MPI.spmd_run(body, 4, timeout=60)
    assert res == [(("cart0",), 4, CPU, ("sp",), {"cart0": 4},
                    {"cart0": 2, "cart1": 2}, {"cart0": 2, "cart1": 2},
                    {"cart0": 2, "cart1": 2}, CPU)] * 4


def test_cart_device_mesh_defaults_to_the_card():
    """With no devices the bridge goes to cuda; a box without CUDA raises."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the default is exercised on it")

    def body():
        MPI.Init()
        line = MPI.Cart_create(MPI.COMM_WORLD, [2], [0], False)
        with pytest.raises(MPI.MPIError, match="CUDA"):
            line.device_mesh()
        MPI.Finalize()
        return True

    assert MPI.spmd_run(body, 2, timeout=60) == [True, True]
