"""Distributed eval command line (counterpart of sam_audio_tpu/eval/main.py;
reference: eval/main.py:45-162).

  python -m sam_audio_tpu_torch.eval.main -s <setting> -p <snapshot> -c 8
  torchrun --nproc_per_node 4 -m sam_audio_tpu_torch.eval.main -s <setting> ...

Data parallelism is per-rank dataset sharding: rank and world come from
torch.distributed when a process group is initialised (the command line
initialises one from torchrun's environment: NCCL on cuda, gloo on the CPU),
else 0 / 1. The per-rank metric sums are combined with
`dist.all_gather_into_tensor` (the reference's all_gather_object,
eval/main.py:19-42). Results land in results/<setting>.json.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from sam_audio_tpu_torch.eval.settings import SETTINGS, make_dataset


def _rank_world():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _dist_allgather(local: np.ndarray) -> np.ndarray:
    """(n,) float64 per rank -> (world, n) on every rank, through the
    initialised process group: on the current CUDA device under NCCL, on the
    CPU otherwise."""
    import torch.distributed as dist

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    mine = torch.as_tensor(local, dtype=torch.float64, device=dev)
    out = torch.empty(dist.get_world_size() * mine.numel(), dtype=torch.float64, device=dev)
    dist.all_gather_into_tensor(out, mine)   # gloo takes only the flat output
    return out.reshape(dist.get_world_size(), -1).cpu().numpy()


def gather_and_average_results(rows: List[Dict[str, float]], multihost: bool = False,
                               _allgather=None, expected_keys: Optional[List[str]] = None,
                               ) -> Dict[str, float]:
    """rows: the per-item metric dicts of this rank. With multihost=True the
    per-rank [sums..., count] vectors are gathered and every rank returns the
    global mean (reference eval/main.py:19-42). `expected_keys` fixes the
    vector's layout, so that a rank with no items still contributes a vector
    of the right shape; a row with a key outside it raises, so that one
    process and many cannot average different things. `_allgather` injects
    the collective (tests)."""
    if expected_keys is not None:
        extra = sorted({k for row in rows for k in row} - set(expected_keys))
        if extra:
            raise ValueError(f"metric rows hold keys outside expected_keys: {extra}; every "
                             "metric must declare the keys it returns")
    summed: Dict[str, float] = {}
    count = 0
    for row in rows:
        for k, v in row.items():
            summed[k] = summed.get(k, 0.0) + float(v)
        count += 1
    if multihost:
        keys = sorted(expected_keys) if expected_keys else sorted(summed)
        local = np.asarray([summed.get(k, 0.0) for k in keys] + [count], np.float64)
        gathered = np.asarray((_allgather or _dist_allgather)(local))
        assert gathered.ndim == 2 and gathered.shape[1] == len(keys) + 1, (
            "rank metric-vector shape mismatch: all ranks must report the same metric keys")
        total = gathered.sum(axis=0)
        summed = {k: float(v) for k, v in zip(keys, total[:-1])}
        count = int(total[-1])
    return {k: v / max(count, 1) for k, v in summed.items()}


def _shard_indices(n: int, rank: int, world: int) -> List[int]:
    return list(range(rank, n, world))


def iter_batches(dset, batch_size: int, rank: int, world: int, prefetch: int = 2):
    """Yields this rank's collated batches; the next batch's decode and
    resample run on one background thread while the caller works on the
    current one (the reference's DataLoader workers, eval/main.py:78-85)."""
    from concurrent.futures import ThreadPoolExecutor

    idxs = _shard_indices(len(dset), rank, world)
    chunks = [idxs[i: i + batch_size] for i in range(0, len(idxs), batch_size)]

    def load(chunk):
        return dset.collate([dset[j] for j in chunk])

    if prefetch <= 0 or len(chunks) <= 1:
        for chunk in chunks:
            yield load(chunk)
        return
    with ThreadPoolExecutor(max_workers=1) as pool:
        futures = [pool.submit(load, c) for c in chunks[:prefetch]]
        next_submit = prefetch
        for _ in range(len(chunks)):
            batch = futures.pop(0).result()
            if next_submit < len(chunks):
                futures.append(pool.submit(load, chunks[next_submit]))
                next_submit += 1
            yield batch


def run_eval(
    settings: List[str],
    cache_path: str,
    batch_size: int,
    checkpoint_path: str,
    reranking_candidates: int = 8,
    model=None,
    processor=None,
    metrics: Optional[List] = None,
    imagebind_metric=None,
    predict_spans: bool = False,
    output_dir: str = "results",
    max_items: Optional[int] = None,
    metric_checkpoints: Optional[Dict[str, str]] = None,
    allow_random_metrics: bool = False,
    device="cuda",
) -> Dict[str, Dict[str, float]]:
    """Each setting through model.separate and the metrics; returns
    {setting: averaged metrics} on every rank, and rank 0 writes
    <output_dir>/<setting>.json. With more than one rank every active metric
    must declare its `keys` (ValueError otherwise)."""
    rank, world = _rank_world()
    mck = metric_checkpoints or {}
    if model is None:
        from sam_audio_tpu_torch import SAMAudio

        model = SAMAudio.from_pretrained(checkpoint_path, device=device)
    if processor is None:
        from sam_audio_tpu_torch import SAMAudioProcessor

        processor = SAMAudioProcessor.from_pretrained(checkpoint_path)
    if metrics is None:
        from sam_audio_tpu_torch.eval.metrics import CLAP, Aesthetic, Judge

        # a metric with no weights raises unless allow_random_metrics
        judge_kw = {"checkpoint": mck["judge"]} if "judge" in mck else {}
        metrics = [Judge(**judge_kw, device=device),
                   Aesthetic(checkpoint=mck.get("aesthetic"), allow_random=allow_random_metrics,
                             device=device),
                   CLAP(checkpoint=mck.get("clap"), allow_random=allow_random_metrics,
                        device=device)]
    if imagebind_metric is None and any(
            SETTINGS[s][1].get("visual") for s in settings if s in SETTINGS):
        from sam_audio_tpu_torch.eval.metrics import ImageBind

        imagebind_metric = ImageBind(checkpoint=mck.get("imagebind"),
                                     allow_random=allow_random_metrics, device=device)

    all_results = {}
    for setting in settings:
        if rank == 0:
            print(f"Evaluating: {setting}")
        dset = make_dataset(setting, cache_path=cache_path, collate_fn=processor)
        active_metrics = list(metrics)
        if dset.visual and imagebind_metric is not None:
            active_metrics.append(imagebind_metric)
        keyless = [getattr(m, "__name__", type(m).__name__) for m in active_metrics
                   if not getattr(m, "keys", None)]
        if world > 1 and keyless:
            raise ValueError(
                f"metrics without `keys` cannot be averaged over {world} ranks: {keyless}; "
                "a rank's vector layout comes from the keys every metric declares")

        rows: List[Dict[str, float]] = []
        seen = 0
        for batch in iter_batches(dset, batch_size, rank, world):
            result = model.separate(batch, reranking_candidates=reranking_candidates,
                                    predict_spans=predict_spans)
            input_wavs = [np.asarray(batch.audios)[i, 0, : int(batch.wav_sizes[i])]
                          for i in range(batch.audios.shape[0])]
            mets: Dict[str, List[float]] = {}
            for metric in active_metrics:
                mets.update(metric(target_wavs=result.target,
                                   target_wavs_sample_rate=model.sample_rate,
                                   descriptions=batch.descriptions, input_wavs=input_wavs,
                                   videos=batch.masked_video))
            n_items = len(result.target)
            rows.extend({k: v[i] for k, v in mets.items()} for i in range(n_items))
            seen += n_items
            if max_items is not None and seen >= max_items:
                break

        expected = None if keyless else sorted(
            {k for m in active_metrics for k in m.keys}) or None
        averaged = gather_and_average_results(rows, multihost=world > 1,
                                              expected_keys=expected)
        all_results[setting] = averaged
        if rank == 0:
            printable = {k: f"{v:.3f}" for k, v in averaged.items()}
            print(json.dumps(printable, indent=4))
            os.makedirs(output_dir, exist_ok=True)
            with open(os.path.join(output_dir, f"{setting}.json"), "w") as fout:
                print(json.dumps(printable), file=fout)
    return all_results


def _init_distributed(device) -> bool:
    """A process group from torchrun's environment (WORLD_SIZE > 1):
    NCCL with this rank's LOCAL_RANK card on cuda, gloo on the CPU. True
    when this call initialised one."""
    import torch.distributed as dist

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return False
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if cuda else "gloo")
    return True


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--setting", "-s", choices=SETTINGS.keys(), default=["instr-pro"],
                        nargs="+")
    parser.add_argument("--cache-path", type=str,
                        default=os.path.expanduser("~/.cache/sam_audio"))
    parser.add_argument("--checkpoint-path", "-p", type=str,
                        default="facebook/sam-audio-large",
                        help="local snapshot directory (config.json + params.npz)")
    parser.add_argument("--batch-size", "-b", type=int, default=1)
    parser.add_argument("--candidates", "-c", type=int, default=8)
    parser.add_argument("--predict-spans", action="store_true")
    parser.add_argument("--max-items", type=int, default=None)
    parser.add_argument("--judge-checkpoint", default=None,
                        help="judge metric snapshot directory (default: facebook/sam-audio-judge)")
    parser.add_argument("--aes-checkpoint", default=None,
                        help="audiobox-aesthetics weights (.pt, or the converter's directory)")
    parser.add_argument("--clap-checkpoint", default=None,
                        help="converted laion_clap weights (npz)")
    parser.add_argument("--imagebind-checkpoint", default=None,
                        help="converted imagebind_huge weights (npz)")
    parser.add_argument("--allow-random-metrics", action="store_true",
                        help="hermetic / dev runs only: score with random metric weights "
                             "(the numbers are meaningless)")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    opt = parser.parse_args(argv)
    mck = {k: v for k, v in (("judge", opt.judge_checkpoint), ("aesthetic", opt.aes_checkpoint),
                             ("clap", opt.clap_checkpoint),
                             ("imagebind", opt.imagebind_checkpoint)) if v}
    owned = _init_distributed(opt.device)
    try:
        return run_eval(settings=opt.setting, cache_path=opt.cache_path,
                        batch_size=opt.batch_size, checkpoint_path=opt.checkpoint_path,
                        reranking_candidates=opt.candidates, predict_spans=opt.predict_spans,
                        max_items=opt.max_items,
                        metric_checkpoints=mck, allow_random_metrics=opt.allow_random_metrics,
                        device=opt.device)
    finally:
        if owned:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
