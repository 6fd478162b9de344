"""Serving path: artifact export, on-device recommender, HTTP endpoint.

Counterpart of ``chaorec_tpu/serve.py``, with the same artifact format
(``FORMAT_VERSION`` 1, the same ``.npz`` keys), so an artifact written by
either package loads in the other:

- ``export_artifact``: snapshot a model into a self-contained ``.npz``:
  the final embedding tables for dot-product models (kind "embeddings"),
  or per-user top-K ranklists for score-mode models such as CF_Diff (kind
  "ranklists"), computed chunk by chunk with the model's own masking;
- ``Recommender``: an artifact on a device, answering ``recommend``
  (history-masked top-k), ``similar_items`` (item-item cosine) and
  ``fold_in`` (a cold user scored from a raw item history);
- ``serve_http``: a stdlib ThreadingHTTPServer JSON API (/healthz,
  /recommend, /similar).

Returned item ids are global (0-based item id + num_user), as in the
reference's ranklists. Seen items are masked by ``eval/ranking.mask_rows``,
the function the trainer's evaluation masks with too.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from chaorec_tpu_torch.eval.ranking import mask_rows as _mask_rows
from chaorec_tpu_torch.eval.ranking import scorer

FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# Export


@torch.inference_mode()
def export_artifact(
    model,
    params,
    model_state,
    dataset,
    path: str,
    score_topk: int = 200,
    eval_user_chunk: int = 4096,
    snapshot: str = "best-epoch",
) -> str:
    """Write a self-contained serving artifact for a model.

    ``kind="embeddings"``: user/item tables from ``model.embeddings``, or
    for a stateful model from ``model.embeddings_stateful(params,
    model_state)`` (DGCF's routing scores shape its tables).
    ``kind="ranklists"``: for rank_mode == "scores" models, per-user top-K
    global item ids and scores, ``eval_user_chunk`` users at a time on the
    model's device (``score_users``, or ``score_users_stateful(params,
    model_state, ids)`` for a stateful model that has it: DualVAE), seen
    items set to ``model.mask_value``.
    """
    common = dict(
        format_version=FORMAT_VERSION,
        model=model.name,
        snapshot=snapshot,  # which weights: "best-epoch" or "final-epoch"
        dataset=dataset.name,
        num_user=dataset.num_user,
        num_item=dataset.num_item,
        history_values=dataset.history.values,
        history_lengths=dataset.history.lengths,
    )
    if model.rank_mode == "embeddings":
        if getattr(model, "stateful", False):
            ue, ie = model.embeddings_stateful(params, model_state)
        else:
            ue, ie = model.embeddings(params)
        np.savez_compressed(
            path, kind="embeddings",
            user_emb=ue.float().cpu().numpy(),
            item_emb=ie.float().cpu().numpy(),
            **common,
        )
    else:
        topk = min(score_topk, dataset.num_item)
        mask_value = float(model.mask_value)
        score_fn = scorer(model, params, model_state)
        ids_out, scores_out = [], []
        for start in range(0, dataset.num_user, eval_user_chunk):
            end = min(start + eval_user_chunk, dataset.num_user)
            scores = score_fn(torch.arange(start, end, device=model.device))
            hist = torch.from_numpy(dataset.history.values[start:end]).to(scores.device)
            v, i = torch.topk(_mask_rows(scores, hist, mask_value), topk, dim=1)
            ids_out.append(i.to(torch.int32).cpu().numpy() + dataset.num_user)
            scores_out.append(v.float().cpu().numpy())
        np.savez_compressed(
            path, kind="ranklists",
            rank_ids=np.concatenate(ids_out, 0),
            rank_scores=np.concatenate(scores_out, 0),
            **common,
        )
    logging.info("serving artifact written to %s", path)
    return path


# ---------------------------------------------------------------------------
# Recommender


def _pairs(idx: torch.Tensor, vals: torch.Tensor, offset: int) -> List[List[Tuple[int, float]]]:
    ids = (idx.cpu().numpy() + offset).tolist()
    scores = vals.float().cpu().numpy().tolist()
    return [list(zip(i, s)) for i, s in zip(ids, scores)]


class Recommender:
    """Serving handle over an exported artifact, with its tables on
    ``device`` (the card unless the caller asks for the CPU). Each query
    enters ``torch.inference_mode`` itself, since the HTTP handler calls it
    from its own threads."""

    def __init__(self, data: Dict[str, np.ndarray], device: torch.device | str = "cuda"):
        fv = int(data["format_version"])
        if fv > FORMAT_VERSION:
            raise ValueError(f"artifact format {fv} newer than supported")
        self.device = torch.device(device)
        self.kind = str(data["kind"])
        self.model_name = str(data["model"])
        self.snapshot = str(data["snapshot"]) if "snapshot" in data else "unknown"
        self.dataset_name = str(data["dataset"])
        self.num_user = int(data["num_user"])
        self.num_item = int(data["num_item"])
        self.history = torch.from_numpy(np.asarray(data["history_values"])).to(self.device)
        if self.kind == "embeddings":
            self.user_emb = torch.from_numpy(np.asarray(data["user_emb"])).to(self.device)
            self.item_emb = torch.from_numpy(np.asarray(data["item_emb"])).to(self.device)
        elif self.kind == "ranklists":
            self.rank_ids = np.asarray(data["rank_ids"])
            self.rank_scores = np.asarray(data["rank_scores"])
        else:
            raise ValueError(f"unknown artifact kind {self.kind!r}")

    @classmethod
    def load(cls, path: str, device: torch.device | str = "cuda") -> "Recommender":
        with np.load(path, allow_pickle=False) as z:
            return cls({k: z[k] for k in z.files}, device)

    def _item_ids(self, item_ids: Sequence[int]) -> np.ndarray:
        """0-based ids from global or 0-based ones (told apart by range)."""
        ids = np.asarray(item_ids, np.int64)
        if ids.min() >= self.num_user:  # global ids
            ids = ids - self.num_user
        if ids.min() < 0 or ids.max() >= self.num_item:
            raise ValueError("item id out of range")
        return ids

    # -- queries ----------------------------------------------------------
    @torch.inference_mode()
    def recommend(
        self, user_ids: Sequence[int], k: int = 10, exclude_seen: bool = True
    ) -> List[List[Tuple[int, float]]]:
        """Top-k (global_item_id, score) per user."""
        users = np.asarray(user_ids, np.int64)
        if users.size == 0:
            return []
        if users.min() < 0 or users.max() >= self.num_user:
            raise ValueError("user id out of range")
        k = min(k, self.num_item)
        if self.kind == "ranklists":
            if k > self.rank_ids.shape[1]:
                raise ValueError(
                    f"artifact caches top-{self.rank_ids.shape[1]} only"
                )
            return [
                list(zip(self.rank_ids[u, :k].tolist(),
                         self.rank_scores[u, :k].tolist()))
                for u in users
            ]
        rows = torch.from_numpy(users).to(self.device)
        # bf16 inputs, fp32 products and sums, as the JAX package scores
        scores = (self.user_emb[rows].to(torch.bfloat16).float()
                  @ self.item_emb.to(torch.bfloat16).float().T)
        if exclude_seen:
            scores = _mask_rows(scores, self.history[rows], float("-inf"))
        vals, idx = torch.topk(scores, k, dim=1)
        return _pairs(idx, vals, self.num_user)

    @torch.inference_mode()
    def similar_items(
        self, item_ids: Sequence[int], k: int = 10
    ) -> List[List[Tuple[int, float]]]:
        """Top-k cosine-similar items. Accepts global OR 0-based item ids;
        returns global ids."""
        if self.kind != "embeddings":
            raise ValueError("similar_items needs an embeddings artifact")
        if len(item_ids) == 0:
            return []
        ids = torch.from_numpy(self._item_ids(item_ids)).to(self.device)
        k = min(k, self.num_item - 1)
        unit = self.item_emb / (
            torch.linalg.vector_norm(self.item_emb, dim=1, keepdim=True) + 1e-12)
        sims = unit[ids] @ unit.T
        sims[torch.arange(ids.numel(), device=self.device), ids] = float("-inf")
        vals, idx = torch.topk(sims, k, dim=1)
        return _pairs(idx, vals, self.num_user)

    @torch.inference_mode()
    def fold_in(
        self, history_items: Sequence[int], k: int = 10
    ) -> List[Tuple[int, float]]:
        """Cold-start user: the user vector is the mean of the history's
        item embeddings, scored against every item without retraining."""
        if self.kind != "embeddings":
            raise ValueError("fold_in needs an embeddings artifact")
        if len(history_items) == 0:
            raise ValueError("history must be non-empty")
        ids = torch.from_numpy(self._item_ids(history_items)).to(self.device)
        u = self.item_emb[ids].mean(dim=0)
        scores = self.item_emb @ u
        scores[ids] = float("-inf")
        vals, idx = torch.topk(scores, min(k, self.num_item))
        return _pairs(idx[None], vals[None], self.num_user)[0]

    def info(self) -> Dict:
        return {
            "kind": self.kind,
            "model": self.model_name,
            "snapshot": self.snapshot,
            "dataset": self.dataset_name,
            "num_user": self.num_user,
            "num_item": self.num_item,
        }


# ---------------------------------------------------------------------------
# HTTP endpoint (stdlib only)


def _make_handler(rec: Recommender):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            logging.debug("http: " + fmt, *args)

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            try:
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path == "/healthz":
                    return self._json(200, {"ok": True, **rec.info()})
                k = int(q.get("k", ["10"])[0])
                if url.path == "/recommend":
                    users = [int(x) for x in q["user"][0].split(",")]
                    exclude = q.get("exclude_seen", ["1"])[0] != "0"
                    recs = rec.recommend(users, k=k, exclude_seen=exclude)
                    return self._json(200, {
                        "results": [
                            {"user": u,
                             "items": [{"item": i, "score": s} for i, s in r]}
                            for u, r in zip(users, recs)
                        ]
                    })
                if url.path == "/similar":
                    items = [int(x) for x in q["item"][0].split(",")]
                    sims = rec.similar_items(items, k=k)
                    return self._json(200, {
                        "results": [
                            {"item": it,
                             "items": [{"item": i, "score": s} for i, s in r]}
                            for it, r in zip(items, sims)
                        ]
                    })
                return self._json(404, {"error": "unknown path"})
            except (KeyError, ValueError) as e:
                return self._json(400, {"error": str(e)})

    return Handler


def serve_http(
    rec: Recommender, port: int = 8080, host: str = "127.0.0.1"
) -> ThreadingHTTPServer:
    """Start the JSON API in a daemon thread; returns the server (call
    ``.shutdown()`` and ``.server_close()`` to stop). Endpoints: /healthz,
    /recommend?user=1,2&k=10, /similar?item=17&k=10."""
    server = ThreadingHTTPServer((host, port), _make_handler(rec))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    logging.info("serving %s on http://%s:%d", rec.model_name, host,
                 server.server_address[1])
    return server


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="Serve a ChaoRec artifact with PyTorch.")
    ap.add_argument("--artifact", required=True)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    rec = Recommender.load(args.artifact, args.device)
    server = serve_http(rec, port=args.port, host=args.host)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()
        server.server_close()


if __name__ == "__main__":
    main()
