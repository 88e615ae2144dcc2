#!/usr/bin/env python3
"""Why csrc/ntc_lattice.cu's ntc_bwd_variant keeps one kernel instance per
path (STAGE): builds tools/staged_view_repro.cu, whose two forms run K13's
column over staged rows in one instance, and shows what each computes and
how its PTX loads the samples. On one GPU:

    python3 tools/staged_view_repro.py

For each form (0: a branch and a struct per path; 1: one call through a
view that is either the kernel's input or the staged rows), with and
without staging, at C 1 and 8: the cells of the reverse-order store that
differ from the plain version (ops/ntc_probe_kernels.bwd_variant_plain) on
the seeded synthetic bucket (2, 256) of chip_smoke.py's phase 16. Then, per
form, the state space of the loads of sig[ti - 1] (the one load at offset
-4 in bwd_column_at) and whether that address comes from the kernel
parameter's sig pointer. Prints the card's name and power limit and the
nvcc version first.
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def entries(ptx: str) -> dict:
    """{kernel name: its PTX body}."""
    parts = re.split(r"(?=\.(?:visible )?\.?entry )", ptx)
    out = {}
    for p in parts:
        m = re.match(r"\.(?:visible )?\.?entry (\S+)\(", p)
        if m:
            out[m.group(1)] = p
    return out


def sig_loads(body: str) -> list[str]:
    """The loads at offset -4, each with whether its address register was
    computed from an ld.param of the kernel's BwdIn (member sig, offset 0)."""
    lines = body.splitlines()
    found = []
    for k, line in enumerate(lines):
        m = re.search(r"\bld\.(\w+)\.f32\s+%f\d+, \[(%r\w*\d+)\+-4\]", line)
        if not m:
            continue
        space, reg = m.group(1), m.group(2)
        if space not in ("global", "shared", "local", "const"):
            space = "generic"
        window = lines[max(0, k - 40):k]
        from_param = False
        for prev in reversed(window):  # the add that formed the address
            if re.search(rf"add\.s64\s+{re.escape(reg)},", prev):
                srcs = re.findall(r"%rd\d+", prev)[1:]
                from_param = any(re.search(rf"(ld\.param\.u64|cvta\.to\.global\.u64)\s+"
                                           rf"{re.escape(r)},", w)
                                 for r in srcs for w in window)
                break
        found.append(f"ld.{space} (address from the kernel parameter: {from_param})")
    return found


def main() -> int:
    import torch

    from dynamont_tpu_torch import _build
    from dynamont_tpu_torch.ops import ntc_batch as nb
    from dynamont_tpu_torch.ops import ntc_kernels as kern
    from dynamont_tpu_torch.ops import ntc_probe_kernels as pk
    from dynamont_tpu_torch.ops.nt_banded_kernels import _ptr, _stream
    from dynamont_tpu_torch.probes.ntc_bwd_synth import synth_inputs

    if not torch.cuda.is_available():
        print("staged_view_repro: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    nvcc = _build.find_nvcc()
    print(subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1])
    out_dir = os.path.join(_build.build_dir(), "staged_view_repro")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(ROOT, "tools", "staged_view_repro.cu")
    flags = [c for c in _build.COMPILE_FLAGS if c not in ("-c", "-v", "-Xptxas")]
    flags += ["-I", _build.CSRC_DIR]
    lib_path = os.path.join(out_dir, "repro.so")
    # --keep leaves the PTX this very build compiled beside the library
    subprocess.run([nvcc, *flags, "-shared", "--keep", "--keep-dir", out_dir, "-o",
                    lib_path, src], check=True)
    ptx_path = os.path.join(out_dir, "staged_view_repro.ptx")

    lib = ctypes.CDLL(lib_path)
    fn = lib.staged_view_repro_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [I] + [P] * 20 + [I] * 7 + [P]
    fn.restype = I

    dev = torch.device("cuda")
    CN, CK0 = 8, 120
    inp = synth_inputs(256, 1024, nb.PlanDims(2, CN, CN + CK0, 4), seed=16, device=dev)
    plan, dims, prm, sig, trans_log, N_r, T_r = inp
    R, CN, CK, A = dims
    T_pad = sig.shape[1] + 1
    want = pk.bwd_variant_plain(*inp, C=8)
    tl = kern.tl_tensor(trans_log, torch.float32, dev)
    for form in (0, 1):
        for C in (1, 8):
            for stage in (0, 1):
                got = torch.full_like(want, float("nan"))
                scratch = torch.empty((R, 5, CN, CK), device=dev)
                rc = fn(form, *kern._bwd_ptrs(plan, prm, sig), _ptr(tl), _ptr(N_r),
                        _ptr(T_r), _ptr(got), _ptr(scratch), R, T_pad, CN, CK, A, C,
                        stage, _stream(dev))
                torch.cuda.synchronize()
                bad = int((got != want).sum()) - int((got.isnan() & want.isnan()).sum())
                print(f"form {form} C {C} stage {stage}: rc {rc}, {bad} of "
                      f"{want.numel()} cells differ from the plain version "
                      f"({100.0 * bad / want.numel():.1f} %)")
    with open(ptx_path) as f:
        ptx = f.read()
    for name, body in entries(ptx).items():
        m = re.search(r"repro_kernelILi(\d)E", name)
        if m:
            print(f"form {m.group(1)} PTX, loads of sig[ti - 1]: {sig_loads(body)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
