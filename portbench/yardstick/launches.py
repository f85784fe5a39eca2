"""The hand-written kernels' launches in one training step, with their
shapes, worked out from the configuration and the job alone: the yardstick
a roofline share sums its bounds over.  `expected_counts` and
`bound_per_step` read the plan of the configuration's model
(`models/<model>.py` `launch_plan`); `plan` is the PhysVerb model's:

- K1: the audio stem, one forward launch a step (its backward is plain
  ops), in float32 under any compute dtype;
- K2: one launch per Swin block and forward; a tower that trains writes
  each row's logsumexp, and with remat its blocks run their forward again
  in the backward;
- K3: one launch per Swin block of a tower that trains;
- K4: two rolls per shifted block and forward, two more in the backward of
  a tower that trains (the opposite rolls) and two more per recompute.

Keys are the program's `launch_counts` keys: `<kernel>` for float32,
`<kernel>.bf16` for bfloat16."""

from .. import models
from . import peaks as P


def swin_blocks(cfg, clips: int):
    """[(W, N, heads, d, nW_img, shifted, (B', T, H, W, C))] per Swin
    block, for `clips` clips folded into windows of frames."""
    rows = clips * (cfg["video_frames"] // cfg["video_window"])
    kt, kh, kw = cfg["swin_patch"]
    grid = [cfg["video_window"] // kt, cfg["video_size"] // kh,
            cfg["video_size"] // kw]
    out = []
    dim = cfg["swin_embed_dim"]
    for s, (depth, heads) in enumerate(zip(cfg["swin_depths"],
                                           cfg["swin_heads"])):
        for i in range(depth):
            window = list(cfg["swin_window"])
            shift = [w // 2 if i % 2 else 0 for w in window]
            for a, size in enumerate(grid):
                if size <= window[a]:
                    window[a], shift[a] = size, 0
            padded = [-(-g // w) * w for g, w in zip(grid, window)]
            n = window[0] * window[1] * window[2]
            n_img = ((padded[0] // window[0]) * (padded[1] // window[1])
                     * (padded[2] // window[2]))
            shifted = any(shift)
            out.append((rows * n_img, n, heads, dim // heads,
                        n_img if shifted else 0, shifted,
                        (rows, *padded, dim)))
        if s < len(cfg["swin_depths"]) - 1:
            grid = [grid[0], -(-grid[1] // 2), -(-grid[2] // 2)]
            dim *= 2
    return out


def plan(cfg, job):
    """{launch key: [(count per step, (flops, bytes, products))]} of one
    training step of `job` (a traffic file's fields)."""
    batch = job["batch_size"]
    bf16 = job["compute_dtype"] == "bfloat16"
    suffix = ".bf16" if bf16 else ""
    modalities = job_modalities(cfg, job)
    out = {}
    if "audio" in modalities:
        out["framed_conv1d"] = [(1, P.k1_work(batch, cfg["audio_samples"],
                                              160, 40, 80, 64))]
    if "video" in modalities:
        trains = not job["video_freeze"]
        forwards = 2 if trains and job["video_remat"] else 1
        k2, k3, k4 = [], [], []
        work2 = P.k2_work_bf16 if bf16 else P.k2_work
        work3 = P.k3_work_bf16 if bf16 else P.k3_work
        for w, n, heads, d, nw, shifted, shape in swin_blocks(cfg, batch):
            k2.append((forwards, work2(w, n, heads, d, nw, lse=trains)))
            if trains:
                k3.append((1, work3(w, n, heads, d, nw)))
            if shifted:
                rolls = 2 * forwards + (2 if trains else 0)
                k4.append((rolls, P.k4_work(*shape, 2 if bf16 else 4)))
        out["window_attention" + suffix] = k2
        if k3:
            out["window_attention_bwd" + suffix] = k3
        if k4:
            out["roll" + suffix] = k4
    return out


AGGR_PRESENCE = {"verb": ("audio", "text"), "phys": ("video",),
                 "phys&verb": ("audio", "text", "video")}
# the heads a presence pattern labels
HEADS = {"verb": ("verb",), "phys": ("phys",), "phys&verb": ("phys", "verb")}


def job_modalities(cfg, job):
    """The modalities a job's batches carry: its presence pattern's, of the
    configuration's."""
    return tuple(m for m in cfg["modalities"]
                 if m in AGGR_PRESENCE[job["aggr_type"]])


def expected_counts(cfg, job):
    """{launch key: launches per step}."""
    return {k: sum(c for c, _ in v)
            for k, v in models.load(cfg).launch_plan(cfg, job).items()}


def bound_per_step(card, cfg, job, key):
    """Seconds: the sum of `key`'s launches' bounds in one step, or None
    when the step launches no such kernel."""
    launches = models.load(cfg).launch_plan(cfg, job).get(key)
    if not launches:
        return None
    return sum(c * P.bound_s(card, *work) for c, work in launches)
