"""The harness: set-up, warm-up, the measured window and its records, for
one cell on one device. ``run.py`` drives it on the card; the tests drive
the same code on the CPU at reduced sizes.

The window drives the program's engine, ``LLMEngine.add_request`` and
``LLMEngine.step`` over ``RealExecutor``, built as
``repro_torch.launch.drive.build_engine`` builds them, on the wall clock:
add every request whose due time has come, step while the engine has work,
sleep to the next due time when it has none. Token times are read on the
host after each step, once the logits have reached it (``RealExecutor``
returns numpy arrays, so every step ends in a synchronisation).

Spans are the harness's own: it times each ``LLMEngine.step`` call, and
wraps the engine's executor so as to time each ``RealExecutor.step`` call
inside it and note the step's shapes (decode batch and contexts, prompts
computed).
"""
from __future__ import annotations

import gc
import sys
import time
from collections import deque
from dataclasses import dataclass, field

import torch

from perfbench import spec, traffic, weights, yardstick

# kernels of the port, by substrings of their names in a device trace
PAGED_KERNELS = ("paged_split", "paged_combine")
FLASH_KERNELS = ("flash_prefill",)
PROFILER_LEAD_S = 5.0   # the profiler starts this long before the window


@dataclass
class Step:
    """One engine step: its span and its executor span (seconds from the
    window's start) and what the executor computed."""
    t0: float
    t1: float = 0.0
    e0: float = 0.0
    e1: float = 0.0
    decode_seqs: int = 0
    decode_ctx: int = 0       # summed context of the decode batch, new token in
    decode_pages: int = 0     # summed pages of the decode batch
    prefills: tuple = ()      # prompt lengths whose prefill was computed


@dataclass
class Tracked:
    """One request of the window, on the harness's clock (seconds from the
    window's start)."""
    req: object
    prompt: list
    due: float
    added: float = 0.0
    first: float | None = None   # first token
    last: float | None = None    # last token inside the window
    tokens: int = 0              # tokens emitted inside the window
    seen: int = 0                # tokens emitted so far
    done: float | None = None
    failed: bool = False


@dataclass
class Trace:
    """The device trace of a window, summarised in memory."""
    busy_s: float
    window_s: float
    kernels: dict                # name -> [seconds, calls]
    intervals: list              # merged busy intervals, seconds from start


@dataclass
class Window:
    cell: spec.Cell
    seconds: float
    steps: list = field(default_factory=list)
    requests: list = field(default_factory=list)  # due inside the window
    lead: list = field(default_factory=list)      # due before it
    trace: Trace | None = None
    waiting: list = field(default_factory=list)   # (time, waiting, running)
    t_start: float = 0.0                          # on the harness's clock
    gaps: list = field(default_factory=list)      # between a request's tokens

    @property
    def config(self) -> dict:
        return self.cell.config


class Setup:
    """The program under test on one device: the model configuration, the
    benchmark's weights from the seed, and engines built on them."""

    def __init__(self, cell: spec.Cell, seed: int, device="cuda",
                 model=None):
        import repro_torch.config as rc
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.model = model or rc.ModelConfig(
            **spec.model_kwargs(cell.config, cell.config_name))
        # the configuration file's keys at the model's sizes
        self.file = reduced_file(cell.config, model) if model else cell.config
        self.engine_kw = spec.engine_kwargs(cell.config)
        if self.device.type == "cuda":
            from repro_torch.kernels import build
            build.build_all()   # the kernels, built once into the checkout
        self.params = None
        self.reseed(seed)

    def reseed(self, seed: int):
        self.seed = seed
        self.params = None
        free(self.device)
        self.params = weights.draw(self.file, seed, self.device)

    def engine(self):
        from repro_torch.launch.drive import build_engine
        kw = dict(self.engine_kw)
        # build_engine turns prefix caching on for the paged families
        if not kw.pop("enable_prefix_caching"):
            raise ValueError("the engine is built with prefix caching on")
        return build_engine(self.model, self.params, self.device, **kw)


def reduced_file(cfg: dict, model) -> dict:
    """A configuration file's keys at another model's sizes (the tests'
    reduced ones)."""
    out = dict(cfg)
    out.update(num_hidden_layers=model.num_layers, hidden_size=model.d_model,
               num_attention_heads=model.num_heads,
               num_key_value_heads=model.num_kv_heads,
               head_dim=model.head_dim, vocab_size=model.vocab_size,
               torch_dtype=model.param_dtype)
    if cfg["family"] == "moe":
        out.update(num_experts=model.num_experts,
                   num_experts_per_tok=model.num_experts_per_tok,
                   moe_intermediate_size=model.moe_d_ff)
    else:
        out["intermediate_size"] = model.d_ff
    return out


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class _Recorder:
    """Wraps an engine's executor: times each executor step and notes what
    it computed."""

    def __init__(self, engine, clock, t_start):
        self.clock, self.t_start = clock, t_start
        self.current: Step | None = None
        ex = engine.executor
        inner = ex.step
        bs = engine.allocator.block_size

        def step(prefills, decode):
            s = self.current
            if decode:
                ctx = [p + 1 for p in decode["pos"]]
                s.decode_seqs = len(ctx)
                s.decode_ctx = sum(ctx)
                s.decode_pages = sum(-(-c // bs) for c in ctx)
            s.prefills = tuple(len(p["token_ids"]) for p in prefills or ()
                               if p["is_last"])
            s.e0 = self.clock() - self.t_start
            out = inner(prefills, decode)
            s.e1 = self.clock() - self.t_start
            return out

        ex.step = step


def _request(item, prompt):
    from repro_torch.engine.request import Request, SamplingParams
    return Request(prompt_tokens=prompt, sampling=SamplingParams(
        temperature=0.0, max_new_tokens=item.output_len,
        target_output_len=item.output_len))


def warm(setup: Setup, engine, seconds: float):
    """Serve a short slice of the cell's own traffic under another seed,
    outputs cut short, all at once, and drain it, on the window's own
    engine: the slice holds the cell's longest prompt, so the largest
    prefill (and its memory) is met before the window."""
    cell = setup.cell
    w = cell.params["warmup"]
    sizes = traffic.sizes(cell.traffic, cell.params, seconds)
    longest = max(sizes)
    pick = [longest] + sizes[:w["requests"] - 1]
    prompts = traffic.tokens(setup.seed, [p for p, _ in pick],
                             setup.model.vocab_size, salt=4)
    for (_, out), prompt in zip(pick, prompts):
        item = traffic.Item(len(prompt), min(out, w["output_tokens"]))
        engine.add_request(_request(item, prompt), 0.0)
    while engine.has_work():
        engine.step(0.0)
    sync(setup.device)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def serve(setup: Setup, engine, seconds: float, seed: int, trace=False,
          rate=None) -> Window:
    """The measured window: the cell's traffic, with token ids from
    ``seed``, for ``seconds`` on the wall clock (``rate`` overrides an open
    loop's, for the knee sweep).

    The loop runs on one clock from ``-lead_in_s`` (the cell's file): what
    it serves before 0 is the lead-in, which brings the engine to the
    cell's own load and decode batch before the window opens at 0. An open
    loop's lead-in is the requests due before 0; a closed loop's is its
    clients' first requests, each under way, primed (their prefills) and
    then served with the rest of the loop. Only requests due inside the
    window enter its tails; every token emitted inside it counts."""
    cell = setup.cell
    mix, params = cell.traffic, cell.params
    lead = params["lead_in_s"]
    clock = time.perf_counter
    win = Window(cell, seconds)
    if mix["loop"] == "open":
        first, rest = [], traffic.open_schedule(
            mix, rate or params["rate_per_s"], seconds, lead)
        ready = deque((i.due, i) for i in rest)   # (due, item) in due order
        rest = deque()
    else:
        first, rest = traffic.closed_plan(mix, params["clients"],
                                          params["rounds"])
        ready, rest = deque(), deque(rest)
    items = first + [i for _, i in ready] + list(rest)
    prompts = traffic.tokens(seed, [i.prompt_len for i in items],
                             setup.model.vocab_size)
    prompt_of = {id(i): p for i, p in zip(items, prompts)}

    def track(item, due, added):
        return Tracked(_request(item, prompt_of[id(item)]),
                       prompt_of[id(item)], due, added=added)

    active = _prime(engine, [track(i, -lead, -lead) for i in first], win)
    # what set-up made lives as long as the run: the collector need not
    # walk it again inside the window
    gc.collect()
    gc.freeze()
    prof = None
    sync(setup.device)
    t_start = clock() + lead
    wall0 = time.time_ns() + 1e9 * lead   # the profiler's clock at 0
    win.t_start = t_start
    rec = _Recorder(engine, clock, t_start)
    end = seconds
    # a client whose first request completed in the priming sends its next
    active = _note_tokens(active, -lead, end, rest, ready, win.gaps)
    while True:
        now = clock() - t_start
        if now >= end:
            break
        if trace and prof is None and now >= -min(lead, PROFILER_LEAD_S):
            # started in the lead-in's last seconds, so that its start-up
            # falls before the window; what it records before 0 is dropped
            prof = _profiler(setup.device)
            prof.__enter__()
        while ready and ready[0][0] <= now:
            due, item = ready.popleft()
            t = track(item, due, now)
            engine.add_request(t.req, now)
            (win.requests if due >= 0 else win.lead).append(t)
            active.append(t)
        if engine.has_work():
            s = Step(t0=clock() - t_start)
            rec.current = s
            engine.step(s.t0)
            s.t1 = clock() - t_start
            if s.e1 and s.t0 >= 0:
                win.steps.append(s)
            if s.t0 >= 0:
                win.waiting.append((s.t1, engine.scheduler.num_waiting(),
                                    engine.scheduler.num_running()))
            active = _note_tokens(active, s.t1, end, rest, ready, win.gaps)
        else:
            nxt = ready[0][0] if ready else end
            time.sleep(max(0.0, min(nxt, end) - (clock() - t_start)))
    gc.unfreeze()   # so that the engine can be freed after the window
    # due inside the window but never sent (the loop was inside a step):
    # each counts, with no token, at its age at the end
    win.requests += [track(item, due, end) for due, item in ready
                     if 0 <= due < end]
    if prof is not None:
        sync(setup.device)
        win_s = clock() - t_start
        prof.__exit__(None, None, None)
        win.trace = _summarise(prof, wall0, win_s, setup.device)
    return win


def _prime(engine, first, win):
    """A closed loop's first requests, each under way: sent and served
    until each has its first token (its prefill done). They are the
    lead-in's: what they emit before the window is not the window's."""
    for t in first:
        engine.add_request(t.req, t.due)
        win.lead.append(t)
    while any(not t.req.output_tokens for t in first):
        engine.step(first[0].due)
    for t in first:
        t.seen = len(t.req.output_tokens)
    return list(first)


def _note_tokens(active, t, end, rest, ready, gaps):
    """Read each active request's tokens after a step ending at ``t``:
    tokens emitted inside the window, [0, end], are the window's. In a
    closed loop a completed request's client sends the next request of
    ``rest`` at once."""
    from repro_torch.engine.request import RequestStatus
    still = []
    for r in active:
        n = len(r.req.output_tokens)
        if n > r.seen:
            if t >= 0:
                if r.first is None:
                    r.first = t
                if t <= end:
                    if r.last is not None:
                        gaps.append(t - r.last)
                    r.tokens += n - r.seen
                    r.last = t
            r.seen = n
        status = r.req.status
        if status is RequestStatus.FINISHED:
            r.done = t
        elif status is RequestStatus.FAILED:
            r.failed = True
        else:
            still.append(r)
            continue
        if rest:
            ready.append((t, rest.popleft()))
    return still


# --------------------------------------------------------------------------
# device trace
# --------------------------------------------------------------------------

def _profiler(device):
    """The device's activity alone (on the CPU, for rehearsals, its ops)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    return profile(activities=[ProfilerActivity.CUDA if cuda
                               else ProfilerActivity.CPU])


def _summarise(prof, wall0_ns: float, window_s: float, device) -> Trace:
    """Device time by kernel name and the merged busy intervals (seconds
    from the window's start, through the profiler's wall clock), read from
    the raw events without building the profiler's per-op tables. What ran
    before the window (the lead-in) is left out."""
    want = (torch.autograd.DeviceType.CUDA
            if torch.device(device).type == "cuda"
            else torch.autograd.DeviceType.CPU)
    kernels: dict = {}
    spans = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != want:
            continue
        a = (e.start_ns() - wall0_ns) / 1e9
        b = min(a + e.duration_ns() / 1e9, window_s)
        a = max(a, 0.0)
        if b <= a:
            continue
        k = kernels.setdefault(e.name(), [0.0, 0])
        k[0] += b - a
        k[1] += 1
        spans.append((a, b))
    spans.sort()
    merged = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    return Trace(busy, window_s, kernels, merged)


def kernel_seconds(trace: Trace, names) -> float:
    return sum(s for k, (s, _) in trace.kernels.items()
               if any(n in k for n in names))


def busy_within(intervals, spans) -> float:
    """Device-busy seconds inside the (start, end) ``spans``, both lists
    sorted and disjoint."""
    total, i = 0.0, 0
    for a, b in spans:
        while i < len(intervals) and intervals[i][1] <= a:
            i += 1
        j = i
        while j < len(intervals) and intervals[j][0] < b:
            total += min(b, intervals[j][1]) - max(a, intervals[j][0])
            j += 1
    return total


# --------------------------------------------------------------------------
# what a window reports
# --------------------------------------------------------------------------

def end_to_end(win: Window) -> dict:
    """The window's end-to-end numbers on the host clock: every request due
    in the window counts, one still open at the window's end with its age
    then."""
    end = win.seconds
    reqs = win.requests
    out = {"output_tokens_per_s":
           sum(r.tokens for r in reqs + win.lead) / end}
    if reqs:
        out["ttft_p90_ms"] = 1e3 * yardstick.percentile(
            [yardstick.censored(r.due, r.first, end) for r in reqs], 90)
        out["e2el_p90_ms"] = 1e3 * yardstick.percentile(
            [yardstick.censored(r.due, r.done, end) for r in reqs], 90)
        tpot = [(r.last - r.first) / (r.tokens - 1) for r in reqs
                if r.tokens >= 2]
        if tpot:
            out["tpot_p90_ms"] = 1e3 * yardstick.percentile(tpot, 90)
        done = [(r.last - r.first) / (r.tokens - 1) for r in reqs
                if r.tokens >= 2 and r.done is not None and r.done <= end]
        if done:
            out["tpot_done_p90_ms"] = 1e3 * yardstick.percentile(done, 90)
        out["ttft_p50_ms"] = 1e3 * yardstick.percentile(
            [yardstick.censored(r.due, r.first, end) for r in reqs], 50)
        out["e2el_p50_ms"] = 1e3 * yardstick.percentile(
            [yardstick.censored(r.due, r.done, end) for r in reqs], 50)
    if win.gaps:
        for q in (50, 90, 99):
            out[f"itl_p{q}_ms"] = 1e3 * yardstick.percentile(win.gaps, q)
    return out


def idle_gaps(win: Window) -> list:
    """Idle device seconds of the traced window by what the host was doing:
    inside executor steps that computed a prefill, inside decode-only
    executor steps, in the engine outside its executor (schedule, sample,
    emit), and outside the engine (waiting for arrivals, the harness)."""
    tr = win.trace
    pre = [(s.e0, s.e1) for s in win.steps if s.prefills]
    dec = [(s.e0, s.e1) for s in win.steps if not s.prefills]
    eng = [(s.t0, s.t1) for s in win.steps]

    def idle(spans):
        return sum(b - a for a, b in spans) - busy_within(tr.intervals, spans)

    inside = idle(eng)
    ex_pre, ex_dec = idle(pre), idle(dec)
    rows = [["executor.step with a prefill: host between kernels", ex_pre],
            ["executor.step decode only: host between kernels", ex_dec],
            ["engine.step outside the executor: schedule, sample, emit",
             inside - ex_pre - ex_dec],
            ["outside engine.step: waiting for arrivals, harness",
             tr.window_s - sum(b - a for a, b in eng)
             - (tr.busy_s - busy_within(tr.intervals, eng))]]
    return sorted(rows, key=lambda r: -r[1])


def device_ops(win: Window, top: int = 10) -> list:
    rows = sorted(win.trace.kernels.items(), key=lambda kv: -kv[1][0])
    return [[k[:120], s] for k, (s, _) in rows[:top]]


def forbidden_modules() -> list:
    """Top-level modules of the JAX side loaded in this process."""
    names = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(names & {"jax", "jaxlib", "flax", "repro"})
