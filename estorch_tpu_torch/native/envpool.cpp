// envpool.cpp — batched environment stepping with a persistent thread pool.
//
// The native runtime component of estorch_tpu (SURVEY.md §2: the reference
// is pure Python and eats the env-stepping cost in per-process Python loops;
// the rebuild's host pipeline replaces that with a C++ pthread env-stepper,
// envpool-style).  This pool steps N classic-control envs in parallel worker
// threads behind a C API consumed via ctypes (envs/native_pool.py), feeding
// device-batched policy inference without per-step Python overhead.
//
// Envs implemented: CartPole-v1 (id 0) and Pendulum-v1 (id 1), matching the
// gymnasium dynamics exactly like the pure-JAX twins (envs/cartpole.py,
// envs/pendulum.py) — the three implementations are parity-tested against
// each other in tests/test_native_pool.py.
//
// Build: make -C estorch_tpu/native   (g++ -O3 -shared -fPIC, pthreads)

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <random>
#include <thread>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

// ----------------------------------------------------------------- envs

struct CartPoleEnv {
  static constexpr int kObsDim = 4;
  static constexpr int kActDim = 1;  // discrete {0,1} passed as float
  static constexpr float kGravity = 9.8f, kMassCart = 1.0f, kMassPole = 0.1f;
  static constexpr float kLength = 0.5f, kForceMag = 10.0f, kTau = 0.02f;
  static constexpr float kThetaThreshold = 12.0f * 2.0f * kPi / 360.0f;
  static constexpr float kXThreshold = 2.4f;

  float s[4];

  void reset(std::mt19937& rng) {
    std::uniform_real_distribution<float> d(-0.05f, 0.05f);
    for (int i = 0; i < 4; i++) s[i] = d(rng);
  }

  // returns done; reward is always 1.0 for an alive step
  bool step(const float* action, float* reward) {
    const float force = (action[0] > 0.5f) ? kForceMag : -kForceMag;
    const float x = s[0], x_dot = s[1], theta = s[2], theta_dot = s[3];
    const float costh = std::cos(theta), sinth = std::sin(theta);
    const float total_mass = kMassCart + kMassPole;
    const float pml = kMassPole * kLength;
    const float temp = (force + pml * theta_dot * theta_dot * sinth) / total_mass;
    const float thetaacc =
        (kGravity * sinth - costh * temp) /
        (kLength * (4.0f / 3.0f - kMassPole * costh * costh / total_mass));
    const float xacc = temp - pml * thetaacc * costh / total_mass;
    s[0] = x + kTau * x_dot;
    s[1] = x_dot + kTau * xacc;
    s[2] = theta + kTau * theta_dot;
    s[3] = theta_dot + kTau * thetaacc;
    *reward = 1.0f;
    return std::fabs(s[0]) > kXThreshold || std::fabs(s[2]) > kThetaThreshold;
  }

  void observe(float* obs) const { std::memcpy(obs, s, sizeof(s)); }
};

struct PendulumEnv {
  static constexpr int kObsDim = 3;
  static constexpr int kActDim = 1;
  static constexpr float kMaxSpeed = 8.0f, kMaxTorque = 2.0f, kDt = 0.05f;
  static constexpr float kG = 10.0f, kM = 1.0f, kL = 1.0f;

  float th, thdot;

  void reset(std::mt19937& rng) {
    std::uniform_real_distribution<float> dth(-kPi, kPi);
    std::uniform_real_distribution<float> dv(-1.0f, 1.0f);
    th = dth(rng);
    thdot = dv(rng);
  }

  static float angle_normalize(float x) {
    return std::fmod(x + kPi, 2.0f * kPi) < 0
               ? std::fmod(x + kPi, 2.0f * kPi) + 2.0f * kPi - kPi
               : std::fmod(x + kPi, 2.0f * kPi) - kPi;
  }

  bool step(const float* action, float* reward) {
    float u = action[0];
    u = u < -kMaxTorque ? -kMaxTorque : (u > kMaxTorque ? kMaxTorque : u);
    const float an = angle_normalize(th);
    const float cost = an * an + 0.1f * thdot * thdot + 0.001f * u * u;
    float newthdot =
        thdot + (3.0f * kG / (2.0f * kL) * std::sin(th) +
                 3.0f / (kM * kL * kL) * u) * kDt;
    newthdot = newthdot < -kMaxSpeed ? -kMaxSpeed
                                     : (newthdot > kMaxSpeed ? kMaxSpeed : newthdot);
    th = th + newthdot * kDt;
    thdot = newthdot;
    *reward = -cost;
    return false;  // pendulum never terminates
  }

  void observe(float* obs) const {
    obs[0] = std::cos(th);
    obs[1] = std::sin(th);
    obs[2] = thdot;
  }
};

// Pong84 (env id 2): a minimal pixel pong rendered to 84x84x1 — the
// conv-rollout stress stand-in for the Atari config (BASELINE config 5) in
// an image without ALE.  The agent drives the LEFT paddle with 3 actions
// (stay/up/down); the right paddle is a simple ball tracker.  Reward +1
// when the opponent misses, -1 when the agent misses; after each point the
// ball re-serves and play continues — the episode ends when either side
// reaches kWinScore points (ALE Pong's play-to-21 match structure), so
// returns span multiple rallies like the real game.  Observation:
// normalized float32 pixels in [0, 1] (ball and paddles drawn white on
// black), flattened row-major 84*84.
struct Pong84Env {
  static constexpr int kSize = 84;
  static constexpr int kObsDim = kSize * kSize;
  static constexpr int kActDim = 1;  // discrete {0,1,2} passed as float
  static constexpr float kPaddleSpeed = 2.0f;
  static constexpr float kOppSpeed = 1.2f;   // beatable tracker
  static constexpr int kPaddleHalf = 6;      // paddle half-height in px
  static constexpr float kBallSpeed = 1.6f;

  static constexpr int kWinScore = 21;  // ALE Pong match length

  float ball_x, ball_y, vel_x, vel_y;  // pixel coordinates
  float left_y, right_y;               // paddle centers
  int left_score, right_score;

  void serve(std::mt19937& rng) {
    std::uniform_real_distribution<float> dy(20.0f, 64.0f);
    std::uniform_real_distribution<float> dv(-0.8f, 0.8f);
    ball_x = kSize / 2.0f;
    ball_y = dy(rng);
    vel_x = (rng() & 1) ? kBallSpeed : -kBallSpeed;
    vel_y = dv(rng);
  }

  void reset(std::mt19937& rng) {
    serve(rng);
    left_y = kSize / 2.0f;
    right_y = kSize / 2.0f;
    left_score = 0;
    right_score = 0;
  }

  bool step(const float* action, float* reward, std::mt19937& rng) {
    const int a = static_cast<int>(action[0] + 0.5f);
    if (a == 1) left_y -= kPaddleSpeed;
    else if (a == 2) left_y += kPaddleSpeed;
    left_y = left_y < kPaddleHalf ? kPaddleHalf
             : (left_y > kSize - kPaddleHalf ? kSize - kPaddleHalf : left_y);

    // opponent tracks the ball with capped speed
    const float dy = ball_y - right_y;
    right_y += dy > kOppSpeed ? kOppSpeed : (dy < -kOppSpeed ? -kOppSpeed : dy);
    right_y = right_y < kPaddleHalf ? kPaddleHalf
              : (right_y > kSize - kPaddleHalf ? kSize - kPaddleHalf : right_y);

    ball_x += vel_x;
    ball_y += vel_y;
    if (ball_y < 1.0f) { ball_y = 1.0f; vel_y = -vel_y; }
    if (ball_y > kSize - 1.0f) { ball_y = kSize - 1.0f; vel_y = -vel_y; }

    *reward = 0.0f;
    // left paddle plane at x=3, right at x=80
    if (ball_x <= 3.0f) {
      if (std::fabs(ball_y - left_y) <= kPaddleHalf + 1.0f) {
        vel_x = -vel_x;
        ball_x = 3.0f;
        std::uniform_real_distribution<float> spin(-0.5f, 0.5f);
        vel_y += spin(rng);
      } else {
        *reward = -1.0f;
        right_score++;
        if (right_score >= kWinScore) return true;
        serve(rng);  // point over, next rally
        return false;
      }
    }
    if (ball_x >= kSize - 4.0f) {
      if (std::fabs(ball_y - right_y) <= kPaddleHalf + 1.0f) {
        vel_x = -vel_x;
        ball_x = kSize - 4.0f;
      } else {
        *reward = 1.0f;
        left_score++;
        if (left_score >= kWinScore) return true;
        serve(rng);
        return false;
      }
    }
    return false;
  }

  void observe(float* obs) const {
    std::memset(obs, 0, sizeof(float) * kObsDim);
    auto draw = [obs](int x, int y) {
      if (x >= 0 && x < kSize && y >= 0 && y < kSize) obs[y * kSize + x] = 1.0f;
    };
    const int by = static_cast<int>(ball_y);
    const int bx = static_cast<int>(ball_x);
    for (int dy = -1; dy <= 1; dy++)
      for (int dx = -1; dx <= 1; dx++) draw(bx + dx, by + dy);
    for (int dy = -kPaddleHalf; dy <= kPaddleHalf; dy++) {
      draw(2, static_cast<int>(left_y) + dy);
      draw(3, static_cast<int>(left_y) + dy);
      draw(kSize - 4, static_cast<int>(right_y) + dy);
      draw(kSize - 3, static_cast<int>(right_y) + dy);
    }
  }
};

// ------------------------------------------------------------ thread pool

// One pool = N envs of one type + a persistent worker team.  Workers park on
// a condition variable between generations; step() broadcasts a job (epoch
// bump), workers each process a contiguous env slice, and the caller waits
// on a completion counter.  No per-step thread spawn, no Python in the loop.
class Pool {
 public:
  Pool(int env_id, int n_envs, int n_threads, uint64_t seed)
      : env_id_(env_id), n_envs_(n_envs),
        n_threads_(n_threads < 1 ? 1 : (n_threads > n_envs ? n_envs : n_threads)) {
    if (env_id_ == 0) cartpoles_.resize(n_envs_);
    else if (env_id_ == 1) pendulums_.resize(n_envs_);
    else pongs_.resize(n_envs_);
    rngs_.reserve(n_envs_);
    for (int i = 0; i < n_envs_; i++) {
      rngs_.emplace_back(static_cast<uint32_t>(seed + 0x9E3779B9u * (i + 1)));
    }
    for (int t = 0; t < n_threads_; t++) {
      workers_.emplace_back([this, t] { worker_loop(t); });
    }
  }

  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      shutdown_ = true;
      epoch_++;
    }
    cv_go_.notify_all();
    for (auto& w : workers_) w.join();
  }

  int obs_dim() const {
    if (env_id_ == 0) return CartPoleEnv::kObsDim;
    if (env_id_ == 1) return PendulumEnv::kObsDim;
    return Pong84Env::kObsDim;
  }
  int act_dim() const {
    if (env_id_ == 0) return CartPoleEnv::kActDim;
    if (env_id_ == 1) return PendulumEnv::kActDim;
    return Pong84Env::kActDim;
  }

  void reset(float* obs_out) {
    run_job(Job{JobKind::kReset, nullptr, obs_out, nullptr, nullptr});
  }

  void step(const float* actions, float* obs_out, float* rew_out, uint8_t* done_out) {
    run_job(Job{JobKind::kStep, actions, obs_out, rew_out, done_out});
  }

 private:
  enum class JobKind { kReset, kStep };
  struct Job {
    JobKind kind;
    const float* actions;
    float* obs;
    float* rew;
    uint8_t* done;
  };

  void run_job(Job job) {
    {
      std::lock_guard<std::mutex> lk(mu_);
      job_ = job;
      remaining_.store(n_threads_, std::memory_order_relaxed);
      epoch_++;
    }
    cv_go_.notify_all();
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [this] { return remaining_.load(std::memory_order_acquire) == 0; });
  }

  void worker_loop(int t) {
    uint64_t seen_epoch = 0;
    const int chunk = (n_envs_ + n_threads_ - 1) / n_threads_;
    const int begin = t * chunk;
    const int end = begin + chunk > n_envs_ ? n_envs_ : begin + chunk;
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_go_.wait(lk, [&] { return epoch_ != seen_epoch; });
        seen_epoch = epoch_;
        if (shutdown_) return;
        job = job_;
      }
      process(job, begin, end);
      if (remaining_.fetch_sub(1, std::memory_order_acq_rel) == 1) {
        std::lock_guard<std::mutex> lk(mu_);
        cv_done_.notify_all();
      }
    }
  }

  void process(const Job& job, int begin, int end) {
    const int od = obs_dim(), ad = act_dim();
    for (int i = begin; i < end; i++) {
      if (job.kind == JobKind::kReset) {
        if (env_id_ == 0) { cartpoles_[i].reset(rngs_[i]); cartpoles_[i].observe(job.obs + i * od); }
        else if (env_id_ == 1) { pendulums_[i].reset(rngs_[i]); pendulums_[i].observe(job.obs + i * od); }
        else { pongs_[i].reset(rngs_[i]); pongs_[i].observe(job.obs + i * od); }
      } else {
        float r = 0.0f;
        bool d;
        if (env_id_ == 0) {
          d = cartpoles_[i].step(job.actions + i * ad, &r);
          // auto-reset so downstream batching never sees a dead env
          if (d) cartpoles_[i].reset(rngs_[i]);
          cartpoles_[i].observe(job.obs + i * od);
        } else if (env_id_ == 1) {
          d = pendulums_[i].step(job.actions + i * ad, &r);
          if (d) pendulums_[i].reset(rngs_[i]);
          pendulums_[i].observe(job.obs + i * od);
        } else {
          d = pongs_[i].step(job.actions + i * ad, &r, rngs_[i]);
          if (d) pongs_[i].reset(rngs_[i]);
          pongs_[i].observe(job.obs + i * od);
        }
        job.rew[i] = r;
        job.done[i] = d ? 1 : 0;
      }
    }
  }

  const int env_id_, n_envs_, n_threads_;
  std::vector<CartPoleEnv> cartpoles_;
  std::vector<PendulumEnv> pendulums_;
  std::vector<Pong84Env> pongs_;
  std::vector<std::mt19937> rngs_;
  std::vector<std::thread> workers_;

  std::mutex mu_;
  std::condition_variable cv_go_, cv_done_;
  Job job_{};
  uint64_t epoch_ = 0;
  std::atomic<int> remaining_{0};
  bool shutdown_ = false;
};

}  // namespace

extern "C" {

void* envpool_create(int env_id, int n_envs, int n_threads, uint64_t seed) {
  if (env_id < 0 || env_id > 2 || n_envs <= 0) return nullptr;
  return new Pool(env_id, n_envs, n_threads, seed);
}

void envpool_destroy(void* h) { delete static_cast<Pool*>(h); }

int envpool_obs_dim(void* h) { return static_cast<Pool*>(h)->obs_dim(); }
int envpool_act_dim(void* h) { return static_cast<Pool*>(h)->act_dim(); }

void envpool_reset(void* h, float* obs_out) {
  static_cast<Pool*>(h)->reset(obs_out);
}

void envpool_step(void* h, const float* actions, float* obs_out,
                  float* rew_out, uint8_t* done_out) {
  static_cast<Pool*>(h)->step(actions, obs_out, rew_out, done_out);
}

}  // extern "C"
