"""The cost of the slow HMM oracle's nested-sampling run
(``tests/test_torch_cuda.py::test_hmm_ns_evidence_agrees_with_laplace_on_the_card``)
on a device, from a short run of the same problem.

    python tests/hmm_ns_card_cost_study.py [cuda|cpu]

Prints the ms of one B = 1 likelihood call (50 calls after 3 warm-up calls)
and the seconds of the first 120 NS iterations at 400 live points; the whole
run takes about 4300 iterations (its CPU run, ``tests/test_torch_hmm.py``)."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import test_torch_cuda as card_tests  # noqa: E402
from bayesianinference_tpu_torch.engines.nested_sampling import nested_sampling  # noqa: E402


def main(device: str) -> None:
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    problem = card_tests._regime_problem_on(dev)
    theta = torch.tensor([[-2.0, 2.0, 2.4, 2.4]], dtype=torch.float64, device=dev)
    for _ in range(3):
        problem.log_likelihood(theta)
    sync()
    t = time.perf_counter()
    for _ in range(50):
        problem.log_likelihood(theta)
    sync()
    print(f"B=1 likelihood call: {(time.perf_counter() - t) / 50 * 1e3:.3f} ms on {dev}", flush=True)
    t = time.perf_counter()
    res = nested_sampling(problem, torch.Generator(dev).manual_seed(1), sample_pool_size=400, max_iterations=120,
                          min_iterations=100)
    print(f"{res.iterations} NS iterations in {time.perf_counter() - t:.1f} s ({res.num_likelihood_evals} likelihood "
          f"evaluations) on {dev}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "cuda")
