"""Multi-object tracker — the nvtracker(NvDCF) + drawDetections counterpart;
port of ``video_stab_tpu/models/tracker.py``.

Mirrors vs::DeepStreamTracker's public surface: ``Parameters``,
``Detection{class_id, confidence, bbox, track_id, label}``,
``process_frame() -> detections`` (async, latest-only queue returning the
PREVIOUS result immediately), ``draw_detections`` with sticky click
selection, and ``pick_id_at``.

Track association is NvDCF-flavored: per-track constant-velocity Kalman on
(cx, cy, w, h) + appearance-fused global-greedy matching (IoU gate, score
= IoU + w * template NCC) + fragment IoM second-chance + NCC-only
re-identification + tentative/lost age management. Each track keeps an
EMA'd grayscale template patch, so geometrically-confusable objects
(crossing paths, bouncing apart while overlapped) keep their ids. The
association is host numpy, copied from the JAX package as it is; the
detector is the port's CenterNet (``models/detector.py``) on the
tracker's device, one forward pass per processed frame.

Without weights the detector is untrained and seeded from 0 by a
``torch.Generator`` (the JAX package's ``PRNGKey(0)`` draws cannot be
reproduced in torch); pass ``detector_params`` to carry trained weights.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from video_stab_tpu_torch import pick_device
from video_stab_tpu_torch.models.detector import (
    CenterNetDetector,
    DetectorConfig,
    TRAFFICCAMNET_LABELS,
    create_detector,
    detect,
)


@dataclasses.dataclass
class Detection:
    """DeepStreamTracker.h:66-72."""

    class_id: int
    confidence: float
    bbox: tuple            # (x, y, w, h) in processing-resolution pixels
    track_id: int = -1
    label: str = ""


@dataclasses.dataclass(frozen=True)
class TrackerParams:
    """DeepStreamTracker::Parameters (h:22-64), minus the TensorRT/
    DeepStream file paths (the model is in-process here)."""

    processing_width: int = 640
    processing_height: int = 384
    batch_size: int = 1
    enable_low_latency: bool = True
    debug_mode: bool = False
    confidence_threshold: float = 0.5
    max_tracked_objects: int = 100
    labels: Sequence[str] = TRAFFICCAMNET_LABELS
    # Association knobs (NvDCF-config equivalents)
    iou_threshold: float = 0.3
    max_lost_age: int = 10        # frames a track survives unmatched
    min_hits: int = 2             # detections before a track is confirmed
    # Appearance model — the NvDCF discriminative-correlation analog
    # (DeepStreamTracker.h:46-52): each track keeps an EMA'd grayscale
    # template patch; candidate (track, det) pairs are scored by
    # IoU + appearance_weight * NCC so two geometrically-confusable
    # objects (crossing paths, bouncing apart) don't swap ids, and a
    # lost track can re-lock onto a distant re-detection by NCC alone.
    enable_appearance: bool = True
    appearance_weight: float = 0.4
    template_size: int = 24       # template patch side (px)
    template_ema: float = 0.25    # new-patch weight at each refresh
    reid_ncc_threshold: float = 0.55
    reid_dist_gate: float = 3.0   # multiples of box diagonal from predict


def _iou(a, b):
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    x1, y1 = max(ax, bx), max(ay, by)
    x2, y2 = min(ax + aw, bx + bw), min(ay + ah, by + bh)
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    union = aw * ah + bw * bh - inter
    return inter / union if union > 0 else 0.0


def _iom(a, b):
    """Intersection over the SMALLER box's area (fragment containment)."""
    ax, ay, aw, ah = a
    bx, by, bw, bh = b
    x1, y1 = max(ax, bx), max(ay, by)
    x2, y2 = min(ax + aw, bx + bw), min(ay + ah, by + bh)
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    smaller = min(aw * ah, bw * bh)
    return inter / smaller if smaller > 0 else 0.0


def _extract_patch(gray: np.ndarray, bbox, size: int) -> Optional[np.ndarray]:
    """(size, size) float32 crop of ``bbox`` from a grayscale frame, or
    None when the clipped box is degenerate."""
    import cv2
    h, w = gray.shape[:2]
    x, y, bw, bh = bbox
    x0 = max(0, min(int(round(x)), w - 1))
    y0 = max(0, min(int(round(y)), h - 1))
    x1 = max(x0 + 1, min(int(round(x + bw)), w))
    y1 = max(y0 + 1, min(int(round(y + bh)), h))
    if x1 - x0 < 2 or y1 - y0 < 2:
        return None
    return cv2.resize(gray[y0:y1, x0:x1].astype(np.float32), (size, size))


def _ncc_matrix(templates: List[Optional[np.ndarray]],
                patches: List[Optional[np.ndarray]]) -> np.ndarray:
    """(T, D) zero-mean normalized cross-correlation in [-1, 1].

    One batched matmul over unit-normalized rows (the template bank and
    detection patches stack into two small matrices) — the cheap dense
    analog of NvDCF's per-track correlation filters. Rows/cols with no
    patch or no contrast (norm ~ 0: a flat crop carries no identity
    evidence) score 0 everywhere.
    """
    t, d = len(templates), len(patches)
    if t == 0 or d == 0:
        return np.zeros((t, d), np.float32)

    def _bank(items):
        flat = [p.ravel() for p in items if p is not None]
        n = flat[0].size if flat else 1
        rows = np.zeros((len(items), n), np.float32)
        ok = np.zeros(len(items), bool)
        for i, p in enumerate(items):
            if p is None:
                continue
            v = p.ravel() - p.mean()
            nv = np.linalg.norm(v)
            if nv < 1e-3:
                continue
            rows[i] = v / nv
            ok[i] = True
        return rows, ok

    tb, tok = _bank(templates)
    pb, pok = _bank(patches)
    if tb.shape[1] != pb.shape[1]:
        return np.zeros((t, d), np.float32)
    ncc = tb @ pb.T
    ncc[~tok] = 0.0
    ncc[:, ~pok] = 0.0
    return ncc


class _Track:
    """Constant-velocity Kalman on (cx, cy, w, h)."""

    def __init__(self, tid, det: Detection):
        x, y, w, h = det.bbox
        self.x = np.array([x + w / 2, y + h / 2, w, h, 0.0, 0.0], np.float64)
        self.p = np.eye(6) * 10.0
        self.tid = tid
        self.class_id = det.class_id
        self.class_votes = {det.class_id: 1}
        self.confidence = det.confidence
        self.hits = 1
        self.age = 0
        self.lost = 0
        # Appearance template: EMA'd grayscale patch (the NvDCF
        # correlation-filter analog). None until a frame is available.
        self.template: Optional[np.ndarray] = None

    def refresh_template(self, patch: Optional[np.ndarray], ema: float):
        """EMA the stored template toward a fresh FULL-detection patch.
        Fragment matches must NOT refresh (the sliver would poison the
        template with occluder pixels) — callers only pass primary-match
        patches."""
        if patch is None:
            return
        if self.template is None:
            self.template = patch.copy()
        else:
            self.template = (1.0 - ema) * self.template + ema * patch

    def predict(self):
        self.x[0] += self.x[4]
        self.x[1] += self.x[5]
        # F P F^T + Q for the block-diagonal CV model
        f = np.eye(6)
        f[0, 4] = f[1, 5] = 1.0
        self.p = f @ self.p @ f.T + np.eye(6) * 0.1
        self.age += 1
        self.lost += 1

    def update(self, det: Detection):
        x, y, w, h = det.bbox
        z = np.array([x + w / 2, y + h / 2, w, h], np.float64)
        hm = np.zeros((4, 6))
        hm[:4, :4] = np.eye(4)
        s = hm @ self.p @ hm.T + np.eye(4) * 1.0
        k = self.p @ hm.T @ np.linalg.inv(s)
        self.x = self.x + k @ (z - hm @ self.x)
        self.p = (np.eye(6) - k @ hm) @ self.p
        self.confidence = det.confidence
        # Sticky class: a partially-occluded object is routinely
        # misclassified frame-to-frame (a car's visible sliver reads as
        # another class); majority vote keeps the identity's label from
        # flapping with each fragment detection.
        self.class_votes[det.class_id] = \
            self.class_votes.get(det.class_id, 0) + 1
        if self.class_votes[det.class_id] > \
                self.class_votes.get(self.class_id, 0):
            self.class_id = det.class_id
        self.hits += 1
        self.lost = 0

    def touch(self, det: Detection):
        """Fragment (second-chance) match: identity evidence ONLY. The
        fragment box measures the visible sliver, not the object — feeding
        it to the Kalman collapses the track's extent and drags its center
        to the occluder edge, after which the real re-emergence can't
        associate. Keep coasting the motion model; just keep the identity
        alive (NvDCF shadow-track semantics)."""
        self.class_votes[det.class_id] = \
            self.class_votes.get(det.class_id, 0) + 1
        self.lost = 0

    @property
    def bbox(self):
        cx, cy, w, h = self.x[:4]
        return (float(cx - w / 2), float(cy - h / 2), float(w), float(h))


class ObjectTracker:
    """In-process detection + tracking with the reference's async contract:
    ``process_frame`` enqueues (latest-only) and returns the PREVIOUS
    detections immediately (DeepStreamTracker.cpp:98-118)."""

    def __init__(self, params: Optional[TrackerParams] = None,
                 detector_cfg: Optional[DetectorConfig] = None,
                 detector_params: Optional[CenterNetDetector] = None,
                 async_mode: bool = True,
                 device: Optional[torch.device] = None):
        """``detector_params``: the detector (a ``CenterNetDetector``, e.g.
        from ``load_detector`` or ``detector_from_flax``); None: an
        untrained one seeded from 0. ``device``: where the detector runs
        (None: CUDA, raising without a card)."""
        self.params = params or TrackerParams()
        cfg = detector_cfg or DetectorConfig(
            num_classes=len(self.params.labels),
            max_detections=self.params.max_tracked_objects)
        self.device = pick_device(True) if device is None \
            else torch.device(device)
        if detector_params is not None:
            self._model = detector_params.to(self.device)
        else:
            self._model = create_detector(
                cfg, height=self.params.processing_height,
                width=self.params.processing_width, device=self.device)
        self._cfg = cfg
        self._tracks: List[_Track] = []
        self._next_id = 1
        self._latest: List[Detection] = []
        self._lock = threading.Lock()
        self._selected_id = -1
        self._frame_count = 0
        self._total_ms = 0.0
        self._async = async_mode
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._stop = threading.Event()
        self._thread = None
        if async_mode:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    # -- inference + association ------------------------------------------
    def _infer(self, frame: np.ndarray) -> List[Detection]:
        import cv2
        p = self.params
        resized = cv2.resize(frame, (p.processing_width, p.processing_height))
        t0 = time.perf_counter()
        out = detect(self._model, resized[None].astype(np.float32),
                     p.confidence_threshold, self._cfg.max_detections)
        dets = []
        valid, cls, score, bbox = (out[k][0].cpu().numpy() for k in
                                   ("valid", "class_id", "score", "bbox"))
        for i in np.nonzero(valid)[0]:
            c = int(cls[i])
            dets.append(Detection(
                class_id=c, confidence=float(score[i]),
                bbox=tuple(float(v) for v in bbox[i]),
                label=p.labels[c] if c < len(p.labels) else str(c)))
        self._total_ms += (time.perf_counter() - t0) * 1e3
        self._frame_count += 1
        gray = (cv2.cvtColor(resized, cv2.COLOR_BGR2GRAY)
                if resized.ndim == 3 else resized)
        return self._associate(dets, gray=gray)

    def _associate(self, dets: List[Detection],
                   gray: Optional[np.ndarray] = None) -> List[Detection]:
        """One association round. ``gray`` is the processing-resolution
        grayscale frame; when provided (and enable_appearance), candidate
        pairs are scored by IoU + appearance_weight * NCC against each
        track's template, and unmatched (lost-track, detection) pairs get
        an NCC-only re-identification pass — the NvDCF shadow-track /
        visual re-ID analog (DeepStreamTracker.h:46-52). Without a frame
        the association is purely geometric (used by unit tests)."""
        p = self.params
        for t in self._tracks:
            t.predict()
        use_app = (gray is not None and p.enable_appearance
                   and self._tracks and dets)
        # Patch extraction only pays off when appearance matching is on —
        # with enable_appearance=False templates are never consulted, so
        # skip the per-detection crop+resize on the hot path.
        patches = ([_extract_patch(gray, d.bbox, p.template_size)
                    for d in dets]
                   if gray is not None and p.enable_appearance else
                   [None] * len(dets))
        if use_app:
            ncc = _ncc_matrix([t.template for t in self._tracks], patches)
        else:
            ncc = np.zeros((len(self._tracks), len(dets)), np.float32)

        # Primary pass: GLOBAL greedy over fused scores (best pair first),
        # IoU-gated. Appearance breaks the geometric ties a crossing
        # creates: when both predicted boxes overlap both detections, the
        # template match decides who is who.
        iou_m = np.zeros((len(self._tracks), len(dets)), np.float32)
        for ti, t in enumerate(self._tracks):
            tb = t.bbox
            for di, d in enumerate(dets):
                iou_m[ti, di] = _iou(tb, d.bbox)
        score = np.where(iou_m > p.iou_threshold,
                         iou_m + p.appearance_weight * np.maximum(ncc, 0.0),
                         -1.0)
        has_t = np.array([t.template is not None for t in self._tracks],
                         bool) if self._tracks else np.zeros(0, bool)
        if use_app and has_t.any():
            # Spatial eligibility for the veto below: only a track that
            # could CLAIM the detection in some pass may visually veto it.
            # Every pass requires proximity (IoU gate, IoM containment, or
            # the re-ID distance gate — the loosest of the three), so a
            # look-alike parked across the frame is not a claimant and
            # must not break a match geometry already settled.
            elig = np.zeros_like(ncc, dtype=bool)
            for ti, t in enumerate(self._tracks):
                cx, cy, tw, th = t.x[:4]
                gate = p.reid_dist_gate * float(np.hypot(tw, th))
                for di, d in enumerate(dets):
                    x, y, bw, bh = d.bbox
                    elig[ti, di] = (np.hypot(x + bw / 2.0 - cx,
                                             y + bh / 2.0 - cy) <= gate)
            col_best = np.where(has_t[:, None] & elig, ncc, -1.0).max(axis=0)
        else:
            col_best = np.full(len(dets), -1.0)
        if use_app and has_t.any():
            # Appearance veto: a detection whose patch matches some OTHER
            # track's template far better (margin 0.3) is visually claimed
            # by that track — geometry alone may not hand it to this one.
            # This is what breaks the crossing swap: after two objects
            # reverse course while overlapped, ONLY the wrong (crossed)
            # pairs pass the IoU gate; the veto kills them and the NCC
            # re-ID pass below re-locks the right identities. The margin
            # keeps ordinary appearance drift (lighting, pose) from ever
            # vetoing a genuine match — it fires only when a much better
            # visual owner exists.
            score = np.where(
                has_t[:, None] & (col_best[None, :] - ncc > 0.3),
                -1.0, score)
        unmatched = list(range(len(dets)))
        pairs = []
        free_t = set(range(len(self._tracks)))
        while free_t and unmatched:
            ti, di = np.unravel_index(int(np.argmax(score)), score.shape)
            if score[ti, di] <= 0.0:
                break
            pairs.append((int(ti), int(di)))
            free_t.discard(int(ti))
            unmatched.remove(int(di))
            score[ti, :] = -1.0
            score[:, di] = -1.0
        # Second chance for unmatched tracks: an object re-emerging from
        # behind an occluder is detected as a FRAGMENT (the visible sliver
        # at the occluder's edge), whose IoU with the full-size predicted
        # box stays far below iou_threshold even when the coasted
        # prediction is spot-on — so the primary pass would mint a fresh
        # identity mid-occlusion. Class-gated fragment containment
        # (intersection over the smaller area) re-locks the existing
        # track instead: the IoU analogue of NvDCF shadow-track
        # re-association (DeepStreamTracker.h:46-52).
        matched = {ti for ti, _ in pairs}
        frag_pairs = []
        for ti, t in enumerate(self._tracks):
            if ti in matched or not unmatched:
                continue
            best, best_iom = -1, 0.5
            for di in unmatched:
                # No class gate here: fragments routinely misclassify
                # (the sliver of a car emerging past an occluder edge
                # reads as another class), and the track's own class is
                # majority-voted, so one fragment can't relabel it. The
                # appearance veto DOES apply: a detection visually claimed
                # far more strongly by another track is not this track's
                # fragment (after a crossing, the coasted prediction sits
                # on the OTHER object with near-total containment — without
                # the veto this pass would eat the detection and starve the
                # re-ID pass below).
                if (use_app and t.template is not None
                        and col_best[di] - ncc[ti, di] > 0.3):
                    continue
                iom = _iom(t.bbox, dets[di].bbox)
                if iom > best_iom:
                    best, best_iom = di, iom
            if best >= 0:
                frag_pairs.append((ti, best))
                unmatched.remove(best)
        # Appearance re-identification: before minting a new id for a
        # leftover detection, try to re-lock it onto a coasting track by
        # template NCC — catches the geometric dead zone (prediction
        # drifted past IoU/IoM reach during a long occlusion, or the
        # object reversed course while hidden). Distance-gated so a
        # look-alike across the frame can't steal an identity.
        matched2 = matched | {ti for ti, _ in frag_pairs}
        reid_pairs = []
        if use_app and unmatched:
            for ti, t in enumerate(self._tracks):
                if ti in matched2 or t.template is None or not unmatched:
                    continue
                cx, cy, w, h = t.x[:4]
                gate = p.reid_dist_gate * float(np.hypot(w, h))
                best, best_ncc = -1, p.reid_ncc_threshold
                for di in unmatched:
                    if ncc[ti, di] <= best_ncc:
                        continue
                    x, y, bw, bh = dets[di].bbox
                    if np.hypot(x + bw / 2 - cx, y + bh / 2 - cy) <= gate:
                        best, best_ncc = di, ncc[ti, di]
                if best >= 0:
                    reid_pairs.append((ti, best))
                    unmatched.remove(best)
        for ti, di in pairs:
            self._tracks[ti].update(dets[di])
            self._tracks[ti].refresh_template(patches[di], p.template_ema)
        for ti, di in frag_pairs:
            self._tracks[ti].touch(dets[di])
        for ti, di in reid_pairs:
            # Full re-lock: the detection is the whole object again.
            # Velocity is stale after the gap — rebase position, zero it.
            t = self._tracks[ti]
            x, y, bw, bh = dets[di].bbox
            t.x[:4] = (x + bw / 2, y + bh / 2, bw, bh)
            t.x[4:] = 0.0
            t.p = np.eye(6) * 10.0
            t.update(dets[di])
            t.refresh_template(patches[di], p.template_ema)
        for di in unmatched:
            nt = _Track(self._next_id, dets[di])
            nt.refresh_template(patches[di], p.template_ema)
            self._tracks.append(nt)
            self._next_id += 1
        self._tracks = [t for t in self._tracks
                        if t.lost <= self.params.max_lost_age]
        out = []
        for t in self._tracks:
            if t.hits >= self.params.min_hits and t.lost == 0:
                out.append(Detection(
                    class_id=t.class_id, confidence=t.confidence,
                    bbox=t.bbox, track_id=t.tid,
                    label=self.params.labels[t.class_id]
                    if t.class_id < len(self.params.labels)
                    else str(t.class_id)))
        return out

    def _loop(self):
        while not self._stop.is_set():
            try:
                frame = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            result = self._infer(frame)
            with self._lock:
                self._latest = result

    # -- public surface (DeepStreamTracker.h:74-92) ------------------------
    def process_frame(self, frame: np.ndarray) -> List[Detection]:
        """Async: enqueue latest-only, return previous detections now."""
        if not self._async:
            result = self._infer(frame)
            with self._lock:
                self._latest = result
            return list(result)
        try:
            self._queue.put_nowait(frame)
        except queue.Full:          # drop oldest (latest-only queue)
            try:
                self._queue.get_nowait()
            except queue.Empty:
                pass
            try:
                self._queue.put_nowait(frame)
            except queue.Full:
                pass
        with self._lock:
            return list(self._latest)

    def draw_detections(self, frame: np.ndarray,
                        detections: Sequence[Detection],
                        sel_x: int = -1, sel_y: int = -1) -> np.ndarray:
        """Draw boxes + labels, sticky-selecting the track under
        (sel_x, sel_y) (drawDetections, DeepStreamTracker.cpp:139-295)."""
        import cv2
        out = frame.copy()
        h, w = frame.shape[:2]
        sx = w / self.params.processing_width
        sy = h / self.params.processing_height
        if sel_x >= 0 and sel_y >= 0:
            picked = self.pick_id_at(sel_x, sel_y, (w, h))
            if picked >= 0:
                self._selected_id = picked
        for d in detections:
            x, y, bw, bh = d.bbox
            p1 = (int(x * sx), int(y * sy))
            p2 = (int((x + bw) * sx), int((y + bh) * sy))
            selected = d.track_id == self._selected_id
            color = (0, 0, 255) if selected else (0, 255, 0)
            cv2.rectangle(out, p1, p2, color, 2 if selected else 1)
            cv2.putText(out, f"{d.label} {d.track_id}",
                        (p1[0], max(p1[1] - 4, 10)),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1)
        if self._frame_count:
            fps = 1000.0 * self._frame_count / max(self._total_ms, 1e-3)
            cv2.putText(out, f"FPS: {fps:.1f}", (10, 20),
                        cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 0), 1)
        return out

    def pick_id_at(self, x: int, y: int,
                   frame_size: Optional[tuple] = None) -> int:
        """Track id under display-space point (pickIdAt,
        DeepStreamTracker.cpp)."""
        sx = sy = 1.0
        if frame_size is not None:
            sx = self.params.processing_width / frame_size[0]
            sy = self.params.processing_height / frame_size[1]
        with self._lock:
            dets = list(self._latest)
        for d in dets:
            bx, by, bw, bh = d.bbox
            if bx <= x * sx <= bx + bw and by <= y * sy <= by + bh:
                return d.track_id
        return -1

    @property
    def mean_inference_ms(self) -> float:
        """Mean host time of one detection (resize excluded, the read of
        its outputs included)."""
        return self._total_ms / self._frame_count if self._frame_count \
            else 0.0

    def release(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


__all__ = ["Detection", "ObjectTracker", "TrackerParams"]
