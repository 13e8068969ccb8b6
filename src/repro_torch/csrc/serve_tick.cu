// Quantized fleet serve tick: one thread per worker, for sm_90a.
//
// Replaces the Pallas TPU kernel src/repro/kernels/serve_tick.py
// (serve_tick / _serve_tick_kernel): the whole int32-quanta dispatch tick
// of one worker -- harvest, wake at E_ON, acquisition of the pending
// assignment, the data-dependent unit loop with the emit reserve and
// mid-unit brown-out, and emission -- fused into one pass that reads each
// state field once and writes it once, in place. The plain version is
// repro_torch.fleet.qtick.tick_q; the two are bit-exact.
//
// What bounds it on an H100: bytes. Per worker it moves 186 B (16 int32 +
// 3 bool read-write fields read and written, 4 int32 read-only fields,
// the harvest quanta, 4 per-worker int32 thresholds, 4 int32 event lanes)
// for a few dozen integer operations, far below the card's operations per
// byte. The design keeps it to that one pass: one thread per worker over a
// 1-D grid of 256-thread blocks (coalesced 4-byte lanes), each thread runs
// its own unit loop (exact: a lane whose `run` is false is unchanged by the
// reference's masked body, so per-lane loops equal its global while-any),
// the cost tables are gathered directly by index (the TPU's one-hot gathers
// and lane-replicated tables are gone), and the 8-lane ledger is reduced
// in the block with warp shuffles and added to one (8,) total with atomics.
//
// Overflow: the reference wraps int32 at 2**31 (e_work/e_harvest roll over
// near 2.147 J); signed overflow is undefined in C++, so every add,
// subtract and multiply runs in uint32_t and is cast back.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kLedger = 8;
constexpr int kPointers = 36;
constexpr int32_t kEvNone = 0, kEvEmit = 1, kEvLost = 2;

struct Args {
  // read-write state, updated in place (RW_FIELDS order)
  int32_t* v;
  bool* on;
  int32_t* cycles;
  int32_t* acquired;
  int32_t* e_work;
  int32_t* e_harvest;
  bool* has_work;
  int32_t* w_ticket;
  int32_t* w_t_acq;
  int32_t* w_cycle_acq;
  int32_t* w_units_done;
  int32_t* w_left;
  int32_t* w_target;
  int32_t* w_tile;
  int32_t* w_wl;
  int32_t* w_batch;
  bool* p_pending;
  int32_t* emit_count;
  int32_t* emit_units_sum;
  // read-only pending assignment (RO_FIELDS order)
  const int32_t* p_ticket;
  const int32_t* p_wl;
  const int32_t* p_units;
  const int32_t* p_batch;
  // this tick's harvest and the per-worker thresholds
  const int32_t* qh;
  const int32_t* e_on;
  const int32_t* e_off;
  const int32_t* e_max;
  const int32_t* estep;
  // workload tables: (n_wl, u_max) unit costs, (n_wl,) fixed and emit
  const int32_t* ucq;
  const int32_t* fixq;
  const int32_t* emitcq;
  // outputs: event lanes (code, tick, ticket, units) and the ledger
  int32_t* ev_code;
  int32_t* ev_tick;
  int32_t* ev_ticket;
  int32_t* ev_units;
  uint32_t* ledger;
  int n;
  int n_wl;
  int u_max;
  int tick;
};

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) *
                              static_cast<uint32_t>(b));
}

// table gather; an index outside the table reads 0, as the reference's
// one-hot gather does
__device__ __forceinline__ int32_t gather(const int32_t* tab, int32_t idx,
                                          int size) {
  return (idx >= 0 && idx < size) ? tab[idx] : 0;
}

// floor modulo for b >= 1 (numpy / jnp / torch `%`); C++ `%` truncates
__device__ __forceinline__ int32_t floor_mod(int32_t a, int32_t b) {
  const int32_t r = a % b;
  return r < 0 ? r + b : r;
}

struct Events {
  int32_t code = kEvNone, tick = 0, ticket = 0, units = 0;
  // first event per worker per tick wins
  __device__ __forceinline__ void rec(int32_t c, int32_t t, int32_t tk,
                                      int32_t u) {
    if (code == kEvNone) {
      code = c;
      tick = t;
      ticket = tk;
      units = u;
    }
  }
};

__global__ void __launch_bounds__(kBlock) serve_tick_kernel(const Args a) {
  const int w = blockIdx.x * kBlock + threadIdx.x;
  uint32_t led[kLedger] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (w < a.n) {
    const int32_t ti = a.tick;
    const int32_t e_on = a.e_on[w], e_off = a.e_off[w], e_max = a.e_max[w];
    const int32_t q = a.qh[w];
    const bool on0 = a.on[w], has_work0 = a.has_work[w];
    const bool p_pending0 = a.p_pending[w];
    const int32_t e_work_in = a.e_work[w];
    Events ev;

    // 1. harvest: bank quanta, saturate at the capacitor ceiling
    const int32_t e_harvest = wadd(a.e_harvest[w], q);
    int32_t E = min(wadd(a.v[w], q), e_max);

    // 2. turn on at E_ON
    const bool waking = !on0 && E >= e_on;
    bool on = on0 || waking;
    const int32_t cycles = wadd(a.cycles[w], waking ? 1 : 0);
    const bool working = on && has_work0;
    const bool idle = on && !has_work0;

    // 3. acquisition: claim the pending assignment (a brown-out is LOST)
    int32_t e_work = e_work_in;
    int32_t acquired = a.acquired[w];
    bool has_work = has_work0;
    int32_t w_ticket = a.w_ticket[w], w_t_acq = a.w_t_acq[w];
    int32_t w_cycle_acq = a.w_cycle_acq[w];
    int32_t w_units_done = a.w_units_done[w], w_left = a.w_left[w];
    int32_t w_target = a.w_target[w], w_tile = a.w_tile[w];
    int32_t w_wl = a.w_wl[w], w_batch = a.w_batch[w];
    const bool due = idle && p_pending0;
    bool succ = false;
    if (due) {
      const int32_t p_wl = a.p_wl[w];
      const int32_t fixed = gather(a.fixq, p_wl, a.n_wl);
      const int32_t take = min(fixed, max(wsub(E, e_off), 0));
      if (wsub(E, take) < e_off) {
        E = e_off;
        on = false;
        ev.rec(kEvLost, ti, a.p_ticket[w], 0);
      } else {
        E = wsub(E, take);
        succ = true;
        e_work = wadd(e_work, fixed);
        acquired = wadd(acquired, 1);
        has_work = true;
        w_ticket = a.p_ticket[w];
        w_t_acq = ti;
        w_cycle_acq = cycles;
        w_units_done = 0;
        w_left = 0;
        w_tile = a.p_units[w];
        w_batch = a.p_batch[w];
        w_target = wmul(a.p_units[w], a.p_batch[w]);
        w_wl = p_wl;
      }
    }

    // 4. progress in-flight work by one tick of active draw
    const int32_t emitc = gather(a.emitcq, w_wl, a.n_wl);
    int32_t e_step = working ? a.estep[w] : 0;
    bool run = working && w_units_done < w_target;
    bool emit_now = false;
    while (run) {
      if (w_left <= 0) {
        // unit boundary: start the next unit only if unit + the emit
        // reserve (the BLE packet) are affordable now, else emit the
        // partial result
        int32_t gidx = w_tile > 0 ? floor_mod(w_units_done, max(w_tile, 1))
                                  : w_units_done;
        gidx = min(max(gidx, 0), a.u_max - 1);
        const int32_t nc = gather(a.ucq, wadd(wmul(w_wl, a.u_max), gidx),
                                  a.n_wl * a.u_max);
        if (max(wsub(E, e_off), 0) < wadd(nc, emitc)) {
          emit_now = true;
          break;
        }
        w_left = nc;
      }
      const int32_t take = min(e_step, w_left);
      if (wsub(E, take) < e_off) {
        // power failure mid-work: volatile by design; work lost
        E = e_off;
        on = false;
        has_work = false;
        ev.rec(kEvLost, ti, w_ticket, 0);
        break;
      }
      E = wsub(E, take);
      e_work = wadd(e_work, take);
      w_left = wsub(w_left, take);
      e_step = wsub(e_step, take);
      if (w_left <= 0) w_units_done = wadd(w_units_done, 1);
      run = e_step > 0 && w_units_done < w_target;
    }

    // 5. emission (BLE packet / host transfer); a failed one loses it
    const bool finish = working && has_work && on &&
                        (w_units_done >= w_target || emit_now);
    bool esucc = false;
    if (finish) {
      if (wsub(E, emitc) < e_off) {
        E = e_off;
        on = false;
        ev.rec(kEvLost, ti, w_ticket, 0);
      } else {
        E = wsub(E, emitc);
        esucc = true;
        e_work = wadd(e_work, emitc);
        ev.rec(kEvEmit, ti, w_ticket, w_units_done);
      }
      has_work = false;
    }

    a.v[w] = E;
    a.on[w] = on;
    a.cycles[w] = cycles;
    a.acquired[w] = acquired;
    a.e_work[w] = e_work;
    a.e_harvest[w] = e_harvest;
    a.has_work[w] = has_work;
    a.w_ticket[w] = w_ticket;
    a.w_t_acq[w] = w_t_acq;
    a.w_cycle_acq[w] = w_cycle_acq;
    a.w_units_done[w] = w_units_done;
    a.w_left[w] = w_left;
    a.w_target[w] = w_target;
    a.w_tile[w] = w_tile;
    a.w_wl[w] = w_wl;
    a.w_batch[w] = w_batch;
    a.p_pending[w] = p_pending0 && !due;
    a.emit_count[w] = wadd(a.emit_count[w], esucc ? 1 : 0);
    a.emit_units_sum[w] = wadd(a.emit_units_sum[w],
                               esucc ? w_units_done : 0);
    a.ev_code[w] = ev.code;
    a.ev_tick[w] = ev.tick;
    a.ev_ticket[w] = ev.ticket;
    a.ev_units[w] = ev.units;

    // ledger lanes: n_emit, n_lost, units_emitted, n_wake, n_acquired,
    // qh_quanta, e_work_quanta, reserved
    led[0] = esucc ? 1u : 0u;
    led[1] = ev.code == kEvLost ? 1u : 0u;
    led[2] = esucc ? static_cast<uint32_t>(w_units_done) : 0u;
    led[3] = waking ? 1u : 0u;
    led[4] = succ ? 1u : 0u;
    led[5] = static_cast<uint32_t>(q);
    led[6] = static_cast<uint32_t>(wsub(e_work, e_work_in));
  }

  // block reduction of the ledger (uint32: wraps like the reference's
  // int32 sums), then one atomic add per lane per block
  __shared__ uint32_t partial[kBlock / 32][kLedger];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kLedger; ++k) {
    uint32_t x = led[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) partial[warp][k] = x;
  }
  __syncthreads();
  if (threadIdx.x < kLedger) {
    uint32_t x = 0;
#pragma unroll
    for (int k = 0; k < kBlock / 32; ++k) x += partial[k][threadIdx.x];
    if (x != 0) atomicAdd(a.ledger + threadIdx.x, x);
  }
}

}  // namespace

// ptrs: the kPointers device addresses in Args order. Launches on `stream`
// with no synchronisation; returns cudaGetLastError() after the launch.
extern "C" int serve_tick_launch(const uint64_t* ptrs, int n_ptrs, int n,
                                 int n_wl, int u_max, int tick,
                                 void* stream) {
  if (n_ptrs != kPointers || n < 1 || n_wl < 1 || u_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  int k = 0;
  auto p = [&](auto& field) {
    field = reinterpret_cast<std::remove_reference_t<decltype(field)>>(
        ptrs[k++]);
  };
  p(a.v), p(a.on), p(a.cycles), p(a.acquired), p(a.e_work), p(a.e_harvest);
  p(a.has_work), p(a.w_ticket), p(a.w_t_acq), p(a.w_cycle_acq);
  p(a.w_units_done), p(a.w_left), p(a.w_target), p(a.w_tile), p(a.w_wl);
  p(a.w_batch), p(a.p_pending), p(a.emit_count), p(a.emit_units_sum);
  p(a.p_ticket), p(a.p_wl), p(a.p_units), p(a.p_batch);
  p(a.qh), p(a.e_on), p(a.e_off), p(a.e_max), p(a.estep);
  p(a.ucq), p(a.fixq), p(a.emitcq);
  p(a.ev_code), p(a.ev_tick), p(a.ev_ticket), p(a.ev_units), p(a.ledger);
  a.n = n;
  a.n_wl = n_wl;
  a.u_max = u_max;
  a.tick = tick;
  const int grid = (n + kBlock - 1) / kBlock;
  serve_tick_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
