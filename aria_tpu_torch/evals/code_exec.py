"""Sandboxed code-evaluation harness (HumanEval-style pass@k).

The port's copy of aria_tpu/evals/code_exec.py.

Parity target: the reference's examples/code_sft/human_eval execution
machinery (execution.py, 808 LoC) — process-isolated execution of
model-generated code with resource limits, timeouts, and a disabled-os-call
guard, plus the unbiased pass@k estimator. Languages: Python in-process
(guarded exec) and compiled/interpreted languages via subprocess toolchains
(C++ with g++ here; the per-language table mirrors the reference's dispatch
and degrades to a "toolchain missing" failure when a compiler is absent).
The sandbox is rlimits + a neutered environment — NOT a security boundary,
same caveat as the reference.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import multiprocessing
import os
import signal
import tempfile
from typing import Dict, List, Optional, Sequence

import numpy as np


def _guard():
    """Best-effort containment for generated code (reference
    reliability_guard semantics): rlimits + disable destructive builtins."""
    import resource

    resource.setrlimit(resource.RLIMIT_AS, (2 << 30, 2 << 30))
    resource.setrlimit(resource.RLIMIT_CPU, (10, 10))
    resource.setrlimit(resource.RLIMIT_FSIZE, (1 << 20, 1 << 20))

    import builtins
    import shutil
    import subprocess as sp

    builtins.exit = None
    builtins.quit = None
    os.system = None
    os.remove = None
    os.removedirs = None
    os.rmdir = None
    os.unlink = None
    os.fork = None
    os.kill = None
    os.killpg = None
    shutil.rmtree = None
    shutil.move = None
    sp.Popen = None
    sp.call = None
    sp.run = None


def _run_one(code: str, timeout: float, result_queue):
    try:
        # tempdir before the guard (the guard disables the os calls that
        # cleanup would need; the dir is abandoned — the process dies anyway).
        d = tempfile.mkdtemp()
        os.chdir(d)
        _guard()

        def _on_alarm(signum, frame):
            raise TimeoutError("execution timed out")

        signal.signal(signal.SIGALRM, _on_alarm)
        stream = io.StringIO()
        with contextlib.redirect_stdout(stream), contextlib.redirect_stderr(stream):
            exec_globals: Dict = {"__name__": "__main__"}
            signal.alarm(int(timeout) + 1)
            exec(compile(code, "<generated>", "exec"), exec_globals)
            signal.alarm(0)
        result_queue.put("passed")
    except BaseException as e:  # noqa: BLE001 — anything from generated code
        result_queue.put(f"failed: {type(e).__name__}: {e}")


# language -> (source filename, compile argv or None, run argv); {d} = tempdir
_SUBPROCESS_LANGS = {
    "cpp": ("main.cpp", ["g++", "-O1", "-std=c++17", "main.cpp", "-o", "main"], ["./main"]),
    "sh": ("main.sh", None, ["bash", "main.sh"]),
    "js": ("main.js", None, ["node", "main.js"]),
    "go": ("main.go", None, ["go", "run", "main.go"]),
}


def _subprocess_limits():
    import resource

    os.setsid()  # own process group: timeouts kill the whole tree
    resource.setrlimit(resource.RLIMIT_AS, (2 << 30, 2 << 30))
    resource.setrlimit(resource.RLIMIT_CPU, (10, 10))
    resource.setrlimit(resource.RLIMIT_FSIZE, (64 << 20, 64 << 20))


def _check_subprocess(program: str, language: str, timeout: float) -> Dict:
    """Compile (if needed) and run one program in a temp dir with rlimits.

    The reference shells out to per-language toolchains the same way
    (execution.py's language table); a missing toolchain is a failure with a
    distinct message, not a crash."""
    import shutil
    import subprocess

    fname, compile_cmd, run_cmd = _SUBPROCESS_LANGS[language]
    if shutil.which((compile_cmd or run_cmd)[0]) is None:
        return {"passed": False,
                "result": f"failed: toolchain missing: {(compile_cmd or run_cmd)[0]}"}
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, fname), "w") as f:
            f.write(program)
        try:
            if compile_cmd is not None:
                c = subprocess.run(
                    compile_cmd, cwd=d, capture_output=True, timeout=60,
                    preexec_fn=_subprocess_limits,
                )
                if c.returncode != 0:
                    return {"passed": False,
                            "result": f"failed: compile: {c.stderr.decode()[:500]}"}
            r = subprocess.run(
                run_cmd, cwd=d, capture_output=True, timeout=timeout,
                preexec_fn=_subprocess_limits,
            )
        except subprocess.TimeoutExpired:
            return {"passed": False, "result": "timed out"}
        if r.returncode != 0:
            return {"passed": False,
                    "result": f"failed: exit {r.returncode}: {r.stderr.decode()[:500]}"}
        return {"passed": True, "result": "passed"}


def check_correctness(
    completion: str,
    test_code: str,
    *,
    entry_point: Optional[str] = None,
    prompt: str = "",
    timeout: float = 10.0,
    language: str = "python",
) -> Dict:
    """Run prompt+completion+tests in an isolated process."""
    program = "\n".join(
        [
            prompt,
            completion,
            test_code,
            f"check({entry_point})" if entry_point and language == "python" else "",
        ]
    )
    if language != "python":
        if language not in _SUBPROCESS_LANGS:
            return {"passed": False, "result": f"failed: unknown language {language}"}
        return _check_subprocess(program, language, timeout)
    # spawn, not fork: the parent typically has JAX's thread pool running and
    # forked children can deadlock in arbitrary library code.
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_run_one, args=(program, timeout, q))
    p.start()
    p.join(timeout + 5)
    if p.is_alive():
        p.kill()
        p.join()
        return {"passed": False, "result": "timed out"}
    result = q.get() if not q.empty() else "failed: no result"
    return {"passed": result == "passed", "result": result}


def pass_at_k(n: int, c: int, k: int) -> float:
    """Unbiased pass@k estimator (Codex paper): 1 - C(n-c, k)/C(n, k)."""
    if n - c < k:
        return 1.0
    return float(1.0 - np.prod(1.0 - k / np.arange(n - c + 1, n + 1)))


def evaluate_functional_correctness(
    samples: Sequence[Dict],  # {"task_id", "completion"}
    problems: Dict[str, Dict],  # task_id -> {"prompt", "test", "entry_point"}
    k_values: Sequence[int] = (1,),
    timeout: float = 10.0,
) -> Dict[str, float]:
    """Returns {"pass@k": ...} over the sample set."""
    per_task: Dict[str, List[bool]] = {}
    for s in samples:
        prob = problems[s["task_id"]]
        res = check_correctness(
            s["completion"], prob["test"],
            entry_point=prob.get("entry_point"), prompt=prob["prompt"],
            timeout=timeout, language=prob.get("language", "python"),
        )
        per_task.setdefault(s["task_id"], []).append(res["passed"])

    out = {}
    for k in k_values:
        vals = [
            pass_at_k(len(results), sum(results), k)
            for results in per_task.values()
            if len(results) >= k
        ]
        out[f"pass@{k}"] = float(np.mean(vals)) if vals else 0.0
    return out
