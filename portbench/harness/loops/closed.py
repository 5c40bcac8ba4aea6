"""The closed loop: `SeparationPipeline.run` over `requests_per_call`
requests of the pool at a time, the next call dispatched as soon as the
last returns, each call one group of the pipeline (k, `max_batch`, the
bucket and the prompt padding from the traffic file, `pad_batch_sizes` on).

Warm-up: `warmup_calls` calls of the cell's own shape, counted as set-up.
The window: calls until `Run.over()`; the device generator's state is saved
before each, so that the check can replay the group's noise.
"""

import time


def drive(run):
    from portbench.harness import traffic
    from sam_audio_tpu_torch.serving import SeparationPipeline

    tr = run.traffic
    pipe = SeparationPipeline(run.model, max_batch=int(tr["max_batch"]),
                              bucket_seconds=float(tr["bucket_seconds"]),
                              reranking_candidates=int(tr["candidates"]),
                              text_pad_to=int(tr["text_pad_to"]))

    def call(i: int):
        reqs = traffic.call(run.pool, tr, i)
        return reqs, pipe.run([run.requests[r.index] for r in reqs])

    warm = int(tr["warmup_calls"])
    for i in range(warm):
        call(i)
        run.mark(f"warm-up call {i}")
    pipe.timer.reset()
    with run.window():
        i = warm
        while not run.over():
            state = run.dev.rng_state()
            c0 = time.perf_counter()
            with run.span("portbench.call"):
                reqs, out = call(i)
            run.record(reqs, out, state, time.perf_counter() - c0)
            i += 1
    run.stages = dict(pipe.timer.summary())
