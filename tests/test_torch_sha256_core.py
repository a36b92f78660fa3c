"""K3, the column SHA-256 absorb of ``csrc/sha256.cu``, on the CPU.

The kernel's thread body (``absorb_thread``: the round warps and the
schedule warps of one CTA, handing blocks over through a two-stage ring
with named barriers) is compiled with g++ and run for every thread of
every CTA of the kernel's own tiling, each thread a coroutine
(``ucontext``) that yields at every ``bar.sync``/``bar.arrive``.  The
harness's barriers count arrivals as the hardware's do (a barrier
releases when its count reaches the CTA's thread count), and a scheduler
resumes the first runnable thread in one of two orders: schedule warps
first (they run as far ahead as the barriers let them, so a stage written
before the round warps have read it shows) or round warps first (so a
round that reads a stage before it is written shows).  A CTA whose threads
all wait is reported as a deadlock.  Each flush is held against the plain
versions ``absorb_stream_plain``/``absorb_stream_planar_plain`` (state,
pending element and carry) and the finished digests against ``hashlib``
per column, for both layouts, every tile size the wrapper can pick, and a
ragged last tile.  Exact: tolerance 0.  Skips without g++.

    python -m pytest tests/test_torch_sha256_core.py -q
"""

import ctypes
import hashlib
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ligero_prover_tpu_torch.ops import sha256 as tsha

from _torch_helpers import rand_limbs, to_t

CSRC = Path(tsha.__file__).resolve().parent.parent / "csrc"

# valid counts per flush (tests/test_torch_sha256.py's schedules at B = 5:
# odd carries, valid < B, an empty flush, full ones), and the commit
# step's two flushes at B = 16 (15 then 9 valid: up to 8 blocks, so the
# ring's stages turn over several times)
SCHEDULES = {
    "odd_carry": (5, [5, 3, 1, 4, 5]),
    "even": (5, [4, 2, 4]),
    "partial_and_empty": (5, [2, 0, 3, 5, 1]),
    "commit_b16": (16, [15, 9, 16]),
}

HARNESS = r"""
#include "sha256.cu"
#include <ucontext.h>
#include <vector>
using namespace ligero_sha;

// The threads of one CTA as coroutines.  wait[t]: 0 runnable, a barrier
// id it waits on, -1 finished.
struct Cta {
  int threads = 0, cur = -1, fault = 0, sched_first = 1, tile = 0;
  int count[8] = {};
  std::vector<int> wait;
  std::vector<ucontext_t> ctx;
  std::vector<std::vector<char>> stacks;
  ucontext_t main_ctx;

  // The first runnable thread: schedule warps [tile, 2 tile) before round
  // warps [0, tile), or the reverse; -1 if none.
  int pick() const {
    for (int k = 0; k < threads; ++k) {
      const int t = sched_first ? (k + tile) % threads : k;
      if (wait[t] == 0) return t;
    }
    return -1;
  }
  // Count one arrival at barrier `id`; release its waiters at `n`.
  bool arrive_at(int id, int n) {
    if (id < 1 || id > 7 || n != threads) { fault = 2; return false; }
    if (++count[id] < n) return false;
    count[id] = 0;
    for (int& w : wait) if (w == id) w = 0;
    return true;
  }
  void yield() { swapcontext(&ctx[cur], &main_ctx); }
};

static Cta* g_cta;

struct HostBar {
  void sync(int id, int n) {
    if (!g_cta->arrive_at(id, n)) g_cta->wait[g_cta->cur] = id;
    g_cta->yield();
  }
  void arrive(int id, int n) {
    g_cta->arrive_at(id, n);
    g_cta->yield();
  }
};

static const Flush* g_flush;
static long long g_tile_index;
static uint32_t* g_ring;

template <bool kPlanar, int kTile>
static void thread_main(int t) {
  HostBar bar;
  absorb_thread<kPlanar, kTile>(*g_flush, g_tile_index, t, g_ring, bar);
  g_cta->wait[t] = -1;
}

template <bool kPlanar, int kTile>
static int run(const Flush& f, int sched_first) {
  const long long tiles = (f.C + kTile - 1) / kTile;
  std::vector<uint32_t> ring(2 * kWords * kTile);
  for (long long tile = 0; tile < tiles; ++tile) {
    Cta cta;
    cta.threads = 2 * kTile;
    cta.tile = kTile;
    cta.sched_first = sched_first;
    cta.wait.assign(cta.threads, 0);
    cta.ctx.resize(cta.threads);
    cta.stacks.resize(cta.threads);
    for (uint32_t& w : ring) w = 0xdeadbeefu;
    g_cta = &cta;
    g_flush = &f;
    g_tile_index = tile;
    g_ring = ring.data();
    for (int t = 0; t < cta.threads; ++t) {
      cta.stacks[t].resize(1 << 16);
      getcontext(&cta.ctx[t]);
      cta.ctx[t].uc_stack.ss_sp = cta.stacks[t].data();
      cta.ctx[t].uc_stack.ss_size = cta.stacks[t].size();
      cta.ctx[t].uc_link = &cta.main_ctx;
      makecontext(&cta.ctx[t], (void (*)())thread_main<kPlanar, kTile>, 1,
                  t);
    }
    for (;;) {
      const int t = cta.pick();
      if (t < 0 || cta.fault) break;
      cta.cur = t;
      swapcontext(&cta.main_ctx, &cta.ctx[t]);
    }
    if (cta.fault) return cta.fault;
    for (int w : cta.wait)
      if (w != -1) return 1;                       // deadlock
  }
  return 0;
}

// The C entry point's flush, run on the host: 0 done, 1 deadlock, 2 a
// barrier used with a bad id or thread count, 3 a bad tile.
extern "C" int absorb_host(const uint32_t* state_in, const uint32_t* pend_in,
                           const uint32_t* rows, uint32_t* state_out,
                           uint32_t* pend_out, long long C, int B,
                           int has_pending, int valid_count, int planar,
                           int tile, int sched_first) {
  if (!tile_ok(tile)) return 3;
  const Flush f = make_flush(state_in, pend_in, rows, state_out, pend_out,
                             C, B, has_pending, valid_count);
  if (planar)
    return tile == 32 ? run<true, 32>(f, sched_first)
                      : run<true, 128>(f, sched_first);
  return tile == 32 ? run<false, 32>(f, sched_first)
                    : run<false, 128>(f, sched_first);
}

extern "C" int tile_ok_host(int tile) { return tile_ok(tile); }
"""


@pytest.fixture(scope="module")
def absorb_host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    work = tmp_path_factory.mktemp("sha_host")
    (work / "harness.cpp").write_text(HARNESS)
    so = work / "libshahost.so"
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{CSRC}", "-o", str(so),
                    str(work / "harness.cpp")], check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.absorb_host
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + \
        [ctypes.c_int] * 6
    fn.restype = ctypes.c_int

    def run(state, pending, has_pending, rows, valid, planar, tile,
            sched_first):
        bsz, cols = (rows.shape[1], rows.shape[2]) if planar else \
            (rows.shape[0], rows.shape[1])
        st_out = torch.full_like(state, -1)
        pe_out = torch.full_like(pending, -1)
        hp = int(bool(has_pending))
        rc = fn(state.data_ptr(), pending.data_ptr(), rows.data_ptr(),
                st_out.data_ptr(), pe_out.data_ptr(), cols, bsz, hp, valid,
                int(planar), tile, int(sched_first))
        assert rc == 0, f"harness fault {rc} (1 deadlock, 2 barrier use)"
        return st_out, pe_out, (valid + hp) % 2 == 1
    run.tile_ok = lib.tile_ok_host
    return run


@pytest.mark.parametrize("sched_first", [True, False],
                         ids=["schedule_first", "rounds_first"])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("cols", [192, 200])
@pytest.mark.parametrize("tile", tsha.TILES)
@pytest.mark.parametrize("planar", [False, True], ids=["aos", "planar"])
def test_host_threads_equal_plain_and_hashlib(absorb_host, planar, tile,
                                              cols, schedule, sched_first):
    """Every thread of both roles, over the kernel's tiling (C = 192: whole
    tiles; C = 200: a ragged last tile), flush by flush against the plain
    version, then the digests against hashlib."""
    bsz, valids = SCHEDULES[schedule]
    gen = np.random.default_rng(1000 * tile + cols + bsz + len(valids))
    h_st = p_st = (tsha.initial_state(cols),
                   torch.zeros((cols, 8), dtype=torch.int32), False)
    absorbed = []
    for valid in valids:
        rows = rand_limbs(gen, (bsz, cols), canonical=False)
        absorbed.append(rows[:valid])
        rows_t = to_t(rows)
        if planar:
            rows_t = rows_t.movedim(-1, 0).contiguous()
            p_st = tsha.absorb_stream_planar_plain(*p_st, rows_t, valid)
        else:
            p_st = tsha.absorb_stream_plain(*p_st, rows_t, valid)
        h_st = absorb_host(*h_st, rows_t, valid, planar, tile, sched_first)
        assert torch.equal(h_st[0], p_st[0])
        assert torch.equal(h_st[1], p_st[1])
        assert h_st[2] == p_st[2]
    stream = np.concatenate(absorbed, axis=0)
    final = tsha.finalize(*h_st, stream.shape[0])
    want = [hashlib.sha256(stream[:, c].astype(">u4").tobytes()).digest()
            for c in range(cols)]
    assert tsha.digests_to_bytes(final) == want


@pytest.mark.parametrize("cols", [1, 31, 192, 200, 16895, 16896, 32768])
def test_tile_choice_is_built(absorb_host, cols):
    """The wrapper picks a tile the source is built for: 32 below 128 per
    SM, else 128; the verifier's 192 columns get 6 CTAs, the commit step's
    32,768 get 256."""
    tile = tsha.tile_for(cols)
    assert tile in tsha.TILES
    assert absorb_host.tile_ok(tile) == 1
    assert tile == (128 if cols >= 128 * tsha.SMS else 32)
    assert absorb_host.tile_ok(64) == 0
