// The CPU emulation's launch and copies (see cuda_runtime.h). A launch runs
// its clusters one after another. Within a cluster every CUDA thread is a
// pthread; in the free schedule all of them run at once, and in an ordered
// one the blocks take turns between cluster barriers, one block at a time,
// in ascending or descending rank order. Where the kernel is free of races
// between ranks, every schedule gives the same bits; where a rank reads
// what another writes between the same two cluster barriers, the two
// orders give different ones. In the same way the warps of a block may
// take turns between block barriers (__syncthreads and named barriers),
// one warp at a time in ascending or descending order, each running to its
// next barrier: a warp that reads what another warp writes before the
// same barrier then sees it in one order and not in the other.
#include <pthread.h>

#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <map>
#include <memory>
#include <mutex>
#include <optional>
#include <thread>

#include "bulk_copy.cuh"
#include "cuda_runtime.h"

namespace emu {
thread_local Ctx ctx;
static int g_order = 0;  // 0 free, 1 ascending ranks, 2 descending
static int g_lazy = 0;   // copies land when waited for
static size_t g_static = 33712;
static int g_sms = 132;
static int g_worder = 0;  // warps: 0 free, 1 ascending, 2 descending
static int g_border = 0;  // clusters of a launch: 0 ascending, 1 descending
size_t static_bytes() { return g_static; }
int sm_count() { return g_sms; }

[[noreturn]] static void die(const char* what) {
  fprintf(stderr, "critic_emu: %s\n", what);
  abort();
}

struct Cluster {
  unsigned size;
  std::mutex m;
  std::condition_variable cv;
  unsigned turn = 0;  // the position in the order whose block runs
  struct Pass {
    Cluster* c;
    void operator()() noexcept {
      std::lock_guard<std::mutex> g(c->m);
      ++c->turn;
      c->cv.notify_all();
    }
  };
  struct Reset {
    Cluster* c;
    void operator()() noexcept {
      std::lock_guard<std::mutex> g(c->m);
      c->turn = 0;
      c->cv.notify_all();
    }
  };
  std::vector<std::unique_ptr<std::barrier<Pass>>> handoff;  // a block's
  std::unique_ptr<std::barrier<Reset>> all;  // every thread of the cluster
  std::vector<Block*> blocks;                 // by rank
  unsigned position(unsigned rank) const {
    return g_order == 2 ? size - 1 - rank : rank;
  }
};

static void wait_turn() {
  if (!g_order) return;
  Cluster& c = *ctx.blk->cluster;
  const unsigned pos = c.position(ctx.blk->rank);
  std::unique_lock<std::mutex> g(c.m);
  if (!c.cv.wait_for(g, std::chrono::seconds(120),
                     [&] { return c.turn == pos; }))
    die("a block waits for its turn for ever");
}
static void pass_turn() {
  if (g_order) ctx.blk->cluster->handoff[ctx.blk->rank]->arrive_and_wait();
}
void* map_shared(void* p, unsigned rank) {
  Block& mine = *ctx.blk;
  const ptrdiff_t off = (char*)p - mine.dyn;
  if (off < 0 || (size_t)off >= mine.dyn_bytes || rank >= mine.cluster->size)
    die("a distributed shared memory address outside the dynamic region");
  return mine.cluster->blocks[rank]->dyn + off;
}
void cluster_sync() {
  pass_turn();
  ctx.blk->cluster->all->arrive_and_wait();
  wait_turn();
}
static thread_local std::optional<std::barrier<Cluster::Reset>::arrival_token>
    t_cluster_token;
void cluster_arrive() {
  pass_turn();
  t_cluster_token.emplace(ctx.blk->cluster->all->arrive());
}
void cluster_wait() {
  if (!t_cluster_token) die("a cluster wait without its arrival");
  ctx.blk->cluster->all->wait(std::move(*t_cluster_token));
  t_cluster_token.reset();
  wait_turn();
}

// ---- the warps' turns within a block ----
struct Turns {
  unsigned nw;
  std::mutex m;
  std::unique_ptr<std::condition_variable[]> cv;  // a warp's
  unsigned pos = 0;  // the position in the order whose warp runs
  std::vector<char> done;
  std::unique_ptr<std::atomic<char>[]> exiting;
  struct Pass {
    Turns* t;
    unsigned w;
    void operator()() noexcept {
      std::lock_guard<std::mutex> g(t->m);
      if (t->exiting[w]) t->done[w] = 1;
      for (unsigned k = 0; k < t->nw; ++k) {
        t->pos = (t->pos + 1) % t->nw;
        if (!t->done[t->warp_at(t->pos)]) break;
      }
      t->cv[t->warp_at(t->pos)].notify_all();
    }
  };
  std::vector<std::unique_ptr<std::barrier<Pass>>> hand;  // a warp's
  unsigned warp_at(unsigned p) const { return g_worder == 2 ? nw - 1 - p : p; }
};

static Turns* turns() { return static_cast<Turns*>(ctx.blk->turns); }
static void warp_wait_turn() {
  if (!g_worder) return;
  Turns& t = *turns();
  const unsigned w = ctx.tid / 32;
  std::unique_lock<std::mutex> g(t.m);
  if (!t.cv[w].wait_for(g, std::chrono::seconds(120),
                        [&] { return t.warp_at(t.pos) == w; }))
    die("a warp waits for its turn for ever");
}
static void warp_pass_turn() {
  if (g_worder) turns()->hand[ctx.tid / 32]->arrive_and_wait();
}
static void warp_exit() {
  if (!g_worder) return;
  turns()->exiting[ctx.tid / 32] = 1;
  warp_pass_turn();
}
void block_barrier(std::barrier<>& bar) {
  warp_pass_turn();
  bar.arrive_and_wait();
  warp_wait_turn();
}
static std::barrier<>& named_barrier(int id, int threads) {
  Block& b = *ctx.blk;
  std::lock_guard<std::mutex> g(b.named_m);
  auto& slot = b.named[id];
  if (!slot) slot.reset(new std::barrier<>(threads));
  return *slot;
}
void named_sync(int id, int threads) {
  block_barrier(named_barrier(id, threads));
}

// ---- copies and mbarriers ----
struct CopyRec {
  void* d;
  const void* s;
  unsigned n = 16;
  bool done = false;
};
using Copies = std::vector<std::shared_ptr<CopyRec>>;
thread_local std::vector<Copies> t_groups;
thread_local Copies t_current;
struct Bar {
  int count = 1, pending = 1;
  long tx = 0, queued = 0;
  unsigned phase = 0;
  struct Bulk {
    void* d;
    const void* s;
    unsigned n;
  };
  std::vector<Bulk> q;          // lazy bulk copies
  std::vector<Copies> arrivals;  // cp.async arrivals not yet landed
};
static std::mutex mu;
static std::condition_variable cv;
static std::map<uint64_t*, Bar> bars;

static void perform(std::shared_ptr<CopyRec>& c) {
  if (!c->done) {
    memcpy(c->d, c->s, c->n);
    c->done = true;
  }
}
static void settle(Bar& b) {
  for (size_t i = 0; i < b.arrivals.size();) {
    bool all = true;
    for (auto& c : b.arrivals[i]) all = all && c->done;
    if (!all) {
      ++i;
      continue;
    }
    b.arrivals.erase(b.arrivals.begin() + i);
    if (--b.pending < 0) die("too many arrivals on an mbarrier");
  }
}
static void try_complete(Bar& b, bool force) {
  if (force)
    for (auto& arr : b.arrivals)
      for (auto& c : arr) perform(c);
  settle(b);
  if (b.pending != 0) return;
  if (g_lazy && b.queued) {
    if (!force || b.tx != b.queued) return;
    for (auto& c : b.q) memcpy(c.d, c.s, c.n);
    b.q.clear();
    b.tx = b.queued = 0;
  } else if (b.tx != 0) {
    return;
  }
  b.phase++;
  b.pending = b.count;
  cv.notify_all();
}
static void settle_all() {
  for (auto& kv : bars) try_complete(kv.second, false);
}

// ---- the launch ----
struct Thread {
  Block* blk;
  unsigned tid;
  void (*body)(void*);
  void* arg;
};
static void* thread_main(void* p) {
  t_groups.clear();
  t_current.clear();
  auto* t = static_cast<Thread*>(p);
  ctx = Ctx{t->blk, t->tid};
  wait_turn();
  warp_wait_turn();
  t->body(t->arg);
  warp_exit();
  pass_turn();
  return nullptr;
}
void run_grid(dim3 grid, dim3 block, size_t dyn, void (*body)(void*),
              void* arg, unsigned per) {
  for (unsigned z = 0; z < grid.z; ++z)
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned k = 0; k < grid.x; k += per) {
      const unsigned c0 = g_border ? (grid.x - 1) / per * per - k : k;
      Cluster cl;
      cl.size = per;
      for (unsigned r = 0; r < per; ++r)
        cl.handoff.emplace_back(
            new std::barrier<Cluster::Pass>(block.x, Cluster::Pass{&cl}));
      cl.all.reset(
          new std::barrier<Cluster::Reset>(per * block.x, Cluster::Reset{&cl}));
      std::vector<Block> blks(per);
      std::vector<std::vector<char>> mem;
      for (unsigned r = 0; r < per; ++r) {
        Block& b = blks[r];
        b.bx = c0 + r;
        b.by = y;
        b.bz = z;
        b.nthreads = block.x;
        b.rank = r;
        b.gx = grid.x;
        b.gy = grid.y;
        b.gz = grid.z;
        b.bar = new std::barrier<>(block.x);
        for (unsigned w = 0; w < block.x / 32; ++w)
          b.warp_bar.push_back(new std::barrier<>(32));
        b.exf.assign(block.x, 0.f);
        b.exu.assign(block.x, 0u);
        // shared memory starts as NaN bytes, so a read of a float that
        // was never written shows
        for (int k = 0; k < 3; ++k) {
          mem.emplace_back(80000, (char)0xff);
          b.shared[k] = mem.back().data();
        }
        mem.emplace_back(dyn + 64, (char)0xff);
        b.dyn = (char*)(((uintptr_t)mem.back().data() + 15) & ~(uintptr_t)15);
        b.dyn_bytes = dyn;
        b.cluster = &cl;
        cl.blocks.push_back(&b);
        Turns* tn = new Turns;
        tn->nw = (block.x + 31) / 32;
        tn->done.assign(tn->nw, 0);
        tn->cv.reset(new std::condition_variable[tn->nw]);
        tn->exiting.reset(new std::atomic<char>[tn->nw]);
        for (unsigned w = 0; w < tn->nw; ++w) {
          tn->exiting[w] = 0;
          tn->hand.emplace_back(new std::barrier<Turns::Pass>(
              std::min(32u, block.x - 32 * w), Turns::Pass{tn, w}));
        }
        b.turns = tn;
      }
      std::vector<Thread> ts(per * block.x);
      std::vector<pthread_t> th(per * block.x);
      pthread_attr_t attr;
      pthread_attr_init(&attr);
      pthread_attr_setstacksize(&attr, 1 << 18);
      for (unsigned i = 0; i < per * block.x; ++i) {
        ts[i] = Thread{&blks[i / block.x], i % block.x, body, arg};
        if (pthread_create(&th[i], &attr, thread_main, &ts[i]))
          die("pthread_create failed");
      }
      // a launch that hangs (a barrier some thread never reaches) ends
      // the process instead of the test run
      std::mutex wm;
      std::condition_variable wcv;
      bool finished = false;
      std::thread watchdog([&] {
        std::unique_lock<std::mutex> g(wm);
        if (!wcv.wait_for(g, std::chrono::seconds(300),
                          [&] { return finished; }))
          die("a cluster ran for 300 s: a barrier some thread never reaches");
      });
      for (auto& t : th) pthread_join(t, nullptr);
      {
        std::lock_guard<std::mutex> g(wm);
        finished = true;
      }
      wcv.notify_all();
      watchdog.join();
      pthread_attr_destroy(&attr);
      std::lock_guard<std::mutex> g(mu);
      for (auto& kv : bars) {
        const Bar& b = kv.second;
        if (b.pending != b.count || b.tx != 0 || !b.q.empty() ||
            !b.arrivals.empty())
          die("copies still in flight when the block exits");
      }
      bars.clear();
      for (auto& b : blks) {
        delete b.bar;
        for (auto* w : b.warp_bar) delete w;
        delete static_cast<Turns*>(b.turns);
      }
    }
}
}  // namespace emu

namespace hypad {
using emu::bars;
using emu::cv;
using emu::mu;
void mbar_init(uint64_t* bar) {
  std::lock_guard<std::mutex> g(mu);
  bars[bar] = emu::Bar{};
}
void mbar_init_count(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> g(mu);
  emu::Bar b;
  b.count = b.pending = (int)count;
  bars[bar] = b;
}
void mbar_expect_bytes(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> g(mu);
  auto& b = bars.at(bar);
  b.tx += bytes;
  b.pending--;
  emu::try_complete(b, false);
}
void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  if (((uintptr_t)dst & 15) || ((uintptr_t)src & 15) || (bytes & 15) ||
      !bytes)
    emu::die("a bulk copy off the 16-byte boundary");
  std::lock_guard<std::mutex> g(mu);
  auto& b = bars.at(bar);
  if (emu::g_lazy) {
    b.q.push_back({dst, src, bytes});
    b.queued += bytes;
  } else {
    memcpy(dst, src, bytes);
    b.tx -= bytes;
    emu::try_complete(b, false);
  }
}
void mbar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> g(mu);
  auto& b = bars.at(bar);
  const auto t0 = std::chrono::steady_clock::now();
  while ((b.phase & 1u) == parity) {
    emu::try_complete(b, true);
    if ((b.phase & 1u) != parity) break;
    cv.wait_for(g, std::chrono::milliseconds(20));
    if (std::chrono::steady_clock::now() - t0 > std::chrono::seconds(60))
      emu::die("an mbarrier wait hangs");
  }
}
void cp_async_n(void* dst, const void* src, unsigned bytes) {
  if (((uintptr_t)dst & (bytes - 1)) || ((uintptr_t)src & (bytes - 1)))
    emu::die("a cp.async off its size's boundary");
  auto rec = std::make_shared<emu::CopyRec>();
  rec->d = dst;
  rec->s = src;
  rec->n = bytes;
  std::lock_guard<std::mutex> g(mu);
  if (!emu::g_lazy) emu::perform(rec);
  emu::t_current.push_back(rec);
}
void cp_async_commit() {
  emu::t_groups.push_back(std::move(emu::t_current));
  emu::t_current.clear();
}
void cp_async_wait_all() {
  std::lock_guard<std::mutex> g(mu);
  for (auto& gr : emu::t_groups)
    for (auto& c : gr) emu::perform(c);
  emu::t_groups.clear();
  for (auto& c : emu::t_current) emu::perform(c);
  emu::t_current.clear();
  emu::settle_all();
}
void cp_async_wait_groups(int pending) {
  std::lock_guard<std::mutex> g(mu);
  while ((int)emu::t_groups.size() > pending) {
    for (auto& c : emu::t_groups.front()) emu::perform(c);
    emu::t_groups.erase(emu::t_groups.begin());
  }
  emu::settle_all();
}
void cp_async_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> g(mu);
  auto& b = bars.at(bar);
  emu::Copies mine;
  for (auto& gr : emu::t_groups)
    for (auto& c : gr)
      if (!c->done) mine.push_back(c);
  for (auto& c : emu::t_current)
    if (!c->done) mine.push_back(c);
  b.arrivals.push_back(std::move(mine));
  emu::try_complete(b, false);
}
}  // namespace hypad

// The schedule of later launches: `order` 0 free, 1 ascending ranks, 2
// descending; `lazy` 1 lands copies only when waited for; the static
// shared memory the launch's plan assumes; the card's SM count (which
// decides the grid's layout). The SM count is read once a device, so it
// is set before the first launch.
// The warps' order within a block in later launches: 0 free, 1 ascending,
// 2 descending (see the top of this file); and the order of a launch's
// clusters (blocks), which run one after another: 0 ascending, 1
// descending.
extern "C" void emu_warp_order(int order) { emu::g_worder = order; }
extern "C" void emu_block_order(int order) { emu::g_border = order; }

extern "C" void critic_emu_schedule(int order, int lazy, long long stat,
                                    int sms) {
  emu::g_order = order;
  emu::g_lazy = lazy;
  emu::g_static = (size_t)stat;
  emu::g_sms = sms;
}
