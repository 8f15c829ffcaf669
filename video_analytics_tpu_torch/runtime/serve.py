"""Long-running clip-classification server (the serving surface).

Port of ``video_analytics_tpu/runtime/serve.py``.  ``tpuva-torch serve``
keeps the process, the model on its device and the built kernels warm
and answers over the same line protocol as ``tpuva serve``.  With shape
normalisation on (default), every input resolution maps to one window
shape on the host.

Protocol: one JSON object per line on stdin → one JSON object per line
on stdout (responses carry the request's "id" when given):

    {"path": "/clip.mp4"}                 → classification
    {"path": "/clip.mp4", "id": 7, "topk": 5}
    {"paths": ["/a.mp4", "/b.mp4"]}       → {"results": [...]} — clips
                                            decoded on two threads, then
                                            ONE batched classify call
    {"cmd": "ping"}                       → {"ok": true}
    {"cmd": "shutdown"}                   → {"ok": true}, then exit

Per-request failures (missing file, corrupt container, bad JSON) are
contained: the server answers {"error": ...} on that line and keeps
serving.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from video_analytics_tpu_torch.config import PipelineConfig
from video_analytics_tpu_torch.ingest.prefetch import prefetch_clips
from video_analytics_tpu_torch.ingest.windows import (
    apply_transport_crop, host_normalize_square)
from video_analytics_tpu_torch.models.two_stream import TwoStreamModel
from video_analytics_tpu_torch.runtime.pipeline import (
    classify_batch, classify_window, sample_window)
from video_analytics_tpu_torch.utils.logging import get_logger

log = get_logger("tpuva.serve")


class ClipServer:
    """Holds the model on its device and answers classify requests.

    normalize=True (default): every decoded clip is host-normalised to
    (T, short, short, 3) (ingest.windows.host_normalize_square), so all
    requests share one window shape and only the cropped region crosses
    to the device.  normalize=False keeps raw frames.
    """

    def __init__(self, model: TwoStreamModel, cfg: PipelineConfig,
                 device: torch.device,
                 classes: Optional[List[str]] = None,
                 num_windows: int = 1, topk: int = 5,
                 normalize: bool = True, max_frames: int = 300):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.classes = classes
        self.num_windows = max(1, num_windows)
        self.topk = topk
        self.normalize = normalize
        self.max_frames = max_frames
        self.window = max(cfg.window, cfg.preprocess.flow_stack + 1)
        self.served = 0

    # -- core ----------------------------------------------------------

    def _windows_from_frames(self, frames: np.ndarray) -> np.ndarray:
        """(T, H, W, 3) → (N, window, h, w, 3) snippet windows."""
        if self.normalize:
            frames = host_normalize_square(
                frames, self.cfg.preprocess.resize_short,
                crop=self.cfg.preprocess.crop)
        t, win, n = len(frames), self.window, self.num_windows
        if n <= 1 or t <= win:
            wins = frames[sample_window(t, win)][None]
            if n > 1:
                wins = np.repeat(wins, n, axis=0)
        else:
            starts = np.linspace(0, t - win, n).astype(int)
            wins = np.stack([frames[s:s + win] for s in starts])
        return wins

    def _to_device(self, wins: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(wins)).to(self.device)

    def _classify_async(self, wins: np.ndarray):
        """Launch the classify work and return the (N, C) or (C,) probs
        tensor without copying it back: on a GPU the kernels are still
        running, and the caller can overlap host work (the next request's
        decode) before ``_classify_fetch``."""
        wins, cfg = apply_transport_crop(wins, self.cfg)
        x = self._to_device(wins)
        if x.shape[0] == 1:
            return classify_window(x[0], self.model, cfg)
        return classify_batch(x, self.model, cfg)

    def _classify_fetch(self, probs: torch.Tensor) -> np.ndarray:
        probs = probs.cpu().numpy()
        return probs if probs.ndim == 1 else probs.mean(0)

    def _classify(self, wins: np.ndarray) -> np.ndarray:
        return self._classify_fetch(self._classify_async(wins))

    def _classify_many(self, wins: np.ndarray) -> np.ndarray:
        """(B, N, win, h, w, 3) stacked clip windows → (B, C) probs in one
        batched classify call over all B·N windows."""
        wins, cfg = apply_transport_crop(wins, self.cfg)
        b, n = wins.shape[:2]
        flat = self._to_device(wins.reshape((b * n,) + wins.shape[2:]))
        probs = classify_batch(flat, self.model, cfg).cpu().numpy()
        return probs.reshape(b, n, -1).mean(1)

    def warmup(self) -> float:
        """Build the kernels and run the classify path once on synthetic
        frames; returns the wall seconds spent.  Only meaningful with
        normalize=True."""
        t0 = time.perf_counter()
        short = self.cfg.preprocess.resize_short
        frames = np.zeros((self.window, short, short, 3), np.uint8)
        self._classify(self._windows_from_frames(frames))
        return time.perf_counter() - t0

    def _load_windows(self, path: str) -> np.ndarray:
        """Decode only the snippet windows the protocol consumes,
        host-normalised to one shape when normalize=True."""
        from video_analytics_tpu_torch.io.video import (
            decode_snippet_windows)
        wins = decode_snippet_windows(path, self.window, self.num_windows,
                                      max_frames=self.max_frames,
                                      repeat_short=True)
        if self.normalize:
            wins = np.stack([host_normalize_square(
                w, self.cfg.preprocess.resize_short,
                crop=self.cfg.preprocess.crop) for w in wins])
        return wins

    def _report(self, path: str, probs: np.ndarray, t0: float,
                topk: Optional[int]) -> Dict[str, Any]:
        k = topk or self.topk
        order = np.argsort(probs)[::-1][:k]
        self.served += 1
        return {
            "path": path,
            "top1": int(order[0]),
            "topk": [{"class_id": int(i),
                      "class_name": (self.classes[i]
                                     if self.classes else None),
                      "prob": float(probs[i])} for i in order],
            "ms": round(1e3 * (time.perf_counter() - t0), 2),
        }

    def classify_path(self, path: str, topk: Optional[int] = None
                      ) -> Dict[str, Any]:
        t0 = time.perf_counter()
        probs = self._classify(self._load_windows(path))
        return self._report(path, probs, t0, topk)

    def classify_paths(self, paths: List[str],
                       topk: Optional[int] = None) -> Dict[str, Any]:
        """Batch request: decode the clips on two host threads
        (``ingest.prefetch_clips``; a path listed twice is decoded once),
        then one batched classify call over them in request order.
        Per-clip decode failures are contained as per-entry errors;
        results come back in request order.  normalize=False classifies
        clip by clip (heterogeneous resolutions cannot share a batch)."""
        t0 = time.perf_counter()
        if not self.normalize:
            results = []
            for p in paths:
                try:
                    results.append(self.classify_path(p, topk=topk))
                except Exception as e:
                    log.warning("request failed: %s (%r)", p, e)
                    results.append({"path": p, "error": repr(e)})
            return {"results": results,
                    "ms": round(1e3 * (time.perf_counter() - t0), 2)}

        failures: List = []
        loaded: Dict[str, np.ndarray] = {}
        # A path listed twice is decoded and classified once; results fan
        # back out by path below.
        uniq = list(dict.fromkeys(paths))
        for p, wins, _dt in prefetch_clips(uniq, self._load_windows,
                                           num_workers=2,
                                           error_log=failures):
            loaded[p] = wins
        errors = dict(failures)
        probs_by_path: Dict[str, np.ndarray] = {}
        oks = [p for p in uniq if p in loaded]
        if oks:
            probs = self._classify_many(np.stack([loaded[p] for p in oks]))
            probs_by_path = dict(zip(oks, probs))
        results = []
        for p in paths:
            if p in probs_by_path:
                results.append(self._report(p, probs_by_path[p], t0, topk))
            else:
                results.append({"path": p,
                                "error": errors.get(p, "decode failed")})
        return {"results": results,
                "ms": round(1e3 * (time.perf_counter() - t0), 2)}

    # -- line protocol ---------------------------------------------------

    def _parse_line(self, line: str):
        """Parse one request line WITHOUT executing it: None for blank
        lines, ("resp", dict) for malformed requests, ("req", dict)
        otherwise — serve_forever needs parse split from execution so it
        can decode request k+1 while request k runs."""
        line = line.strip()
        if not line:
            return None
        try:
            req = json.loads(line)
            if not isinstance(req, dict):
                raise ValueError("request must be a JSON object")
        except ValueError as e:
            return ("resp", {"error": f"bad request: {e}"})
        return ("req", req)

    @staticmethod
    def _is_single_classify(req: Dict[str, Any]) -> bool:
        return (req.get("cmd") is None and req.get("paths") is None
                and bool(req.get("path")))

    def handle_line(self, line: str) -> Optional[Dict[str, Any]]:
        """One request line → response dict, or None for blank lines.
        A {"cmd": "shutdown"} response carries {"_shutdown": True} for
        the loop to act on after writing the reply."""
        parsed = self._parse_line(line)
        if parsed is None:
            return None
        kind, payload = parsed
        if kind == "resp":
            return payload
        return self.handle_request(payload)

    def handle_request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        rid = req.get("id")

        def tag(resp):
            if rid is not None:
                resp["id"] = rid
            return resp

        cmd = req.get("cmd")
        if cmd == "ping":
            return tag({"ok": True, "served": self.served})
        if cmd == "shutdown":
            return tag({"ok": True, "_shutdown": True})
        if cmd is not None:
            return tag({"error": f"unknown cmd: {cmd!r}"})
        paths = req.get("paths")
        if paths is not None:
            if (not isinstance(paths, list) or not paths
                    or not all(isinstance(p, str) for p in paths)):
                return tag({"error": "'paths' must be a non-empty "
                                     "list of strings"})
            try:
                return tag(self.classify_paths(paths,
                                               topk=req.get("topk")))
            except Exception as e:   # contain, keep serving
                log.warning("batch request failed (%r)", e)
                return tag({"error": repr(e)})
        path = req.get("path")
        if not path:
            return tag({"error": "request needs a 'path', 'paths' or "
                                 "'cmd'"})
        try:
            return tag(self.classify_path(path, topk=req.get("topk")))
        except Exception as e:  # corrupt/missing clip: contain, keep serving
            log.warning("request failed: %s (%r)", path, e)
            return tag({"path": path, "error": repr(e)})

    def serve_forever(self, stdin=None, stdout=None) -> int:
        """Blocking stdin→stdout loop; returns the number served.

        A reader thread keeps the request queue fed, and each single
        classify request decodes on a one-deep decode-ahead thread: while
        request k's work runs, request k+1 is already decoding on the
        host.  Responses keep strict request order, and a ping-pong
        client (one request, wait for the reply) is answered at once —
        the loop never blocks on line k+1 before answering line k.
        """
        import queue as _q
        import threading

        stdin = stdin or sys.stdin
        stdout = stdout or sys.stdout
        _EOF = object()
        lines: "_q.Queue" = _q.Queue(maxsize=64)

        def _reader():
            try:
                for ln in stdin:
                    lines.put(ln)
            finally:
                lines.put(_EOF)

        threading.Thread(target=_reader, daemon=True).start()

        def emit(resp: Dict[str, Any]) -> bool:
            shutdown = resp.pop("_shutdown", False)
            stdout.write(json.dumps(resp) + "\n")
            stdout.flush()
            return shutdown

        class _DecodeJob:
            """One single-path classify request decoding on a thread."""

            def __init__(job, req):
                job.req = req
                job.t0 = time.perf_counter()
                job.wins = None
                job.err: Optional[BaseException] = None
                job.thread = threading.Thread(target=job._run,
                                              daemon=True)
                job.thread.start()

            def _run(job):
                try:
                    job.wins = self._load_windows(job.req["path"])
                except Exception as e:
                    job.err = e

        ahead = None        # _DecodeJob | ("resp", dict) | ("req", dict)
        eof = False
        while not eof:
            if ahead is not None:
                item, ahead = ahead, None
            else:
                ln = lines.get()
                if ln is _EOF:
                    break
                item = self._parse_line(ln)
                if item is None:
                    continue
                if item[0] == "req" and self._is_single_classify(item[1]):
                    item = _DecodeJob(item[1])
            if not isinstance(item, _DecodeJob):
                kind, payload = item
                resp = (payload if kind == "resp"
                        else self.handle_request(payload))
                if emit(resp):
                    break
                continue
            # Classify: join the decode, launch the work ...
            job = item
            job.thread.join()
            handle = None
            if job.err is None:
                try:
                    handle = self._classify_async(job.wins)
                except Exception as e:
                    job.err = e
            # ... and start the NEXT request's decode (if one is already
            # queued) before fetching this one's result.  Never block
            # here: a ping-pong client is answered at once.
            try:
                ln = lines.get_nowait()
            except _q.Empty:
                ln = None
            if ln is _EOF:
                eof = True
            elif ln is not None:
                nxt = self._parse_line(ln)
                if nxt is not None:
                    if (nxt[0] == "req"
                            and self._is_single_classify(nxt[1])):
                        ahead = _DecodeJob(nxt[1])
                    else:
                        ahead = nxt
            req = job.req
            rid = req.get("id")
            if job.err is not None:
                log.warning("request failed: %s (%r)",
                            req.get("path"), job.err)
                resp = {"path": req.get("path"), "error": repr(job.err)}
            else:
                try:
                    probs = self._classify_fetch(handle)
                    resp = self._report(req["path"], probs, job.t0,
                                        req.get("topk"))
                except Exception as e:      # contain, keep serving
                    log.warning("request failed: %s (%r)",
                                req.get("path"), e)
                    resp = {"path": req.get("path"), "error": repr(e)}
            if rid is not None:
                resp["id"] = rid
            if emit(resp):
                break
        return self.served
