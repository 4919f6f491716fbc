"""Benchmark of the PyTorch / CUDA port on one GPU: the full System's
tracked frames/s and the tracking hot path as one CUDA graph (the port of
bench.py; see coslam_tpu_torch/bench.py).

    python3 bench_torch.py [--device cuda] [--frames 120] [--repeats 3]
                           [--batch 64] [--seed S]
                           [--mapper-latency-frames -1]

The last line of its output is one JSON object with bench.py's keys.
"""

from coslam_tpu_torch.bench import main

if __name__ == "__main__":
    raise SystemExit(main())
