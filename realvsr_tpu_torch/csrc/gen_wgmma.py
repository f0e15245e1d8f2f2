"""Write ``wgmma.cuh``: the Hopper ``wgmma.mma_async`` instructions that
``conv3x3.cu``, ``dcn_fwd.cu``, ``dcn_bwd.cu`` and ``dcn_narrow.cu`` run,
one inline-asm wrapper per (element type, N), with A from registers
(``Wgmma``) or from shared memory (``WgmmaSS``), and in bf16 with A from
shared memory and B read transposed, MN-major (``WgmmaSSTB``).

An inline-asm operand list cannot be built by templates, and the N/2 f32
accumulators of an m64nN product each need their own operand, so the
wrappers are written out here.  Run from the repository's root after
changing :data:`WIDTHS`:

    python -m realvsr_tpu_torch.csrc.gen_wgmma

``tests/test_torch_conv_pack.py`` checks that the header is up to date.
"""
from __future__ import annotations

from pathlib import Path

# the kernel's output widths (N of m64nN); the wrapper pads cout up to one
WIDTHS = (8, 16, 32, 64, 128, 216, 256)
# the widths with A read from shared memory too (dcn_fwd.cu at 128
# channels: 128; dcn_bwd.cu's dS at 128: 16; dcn_narrow.cu's forward at
# its output widths, its backward's dS: 64, its bf16 dW with B transposed:
# its cotangent chunks)
SS_WIDTHS = (8, 16, 32, 64, 128, 256)
TB_WIDTHS = (16, 32, 64, 128, 256)
# (C++ type, PTX K of one instruction, PTX type, trailing immediates with A
# from registers, with A from shared memory): B K-major from shared memory
# through a descriptor; A from shared memory K-major too (TF32 takes no
# transpose immediates; bf16's last one, 1 in WgmmaSSTB, reads B
# MN-major)
TYPES = (("__nv_bfloat16", 16, "bf16", "p, 1, 1, 0", "p, 1, 1, 0, 0"),
         ("float", 8, "tf32", "p, 1, 1", "p, 1, 1"))
HEADER = Path(__file__).with_name("wgmma.cuh")


def _wrapper(ctype: str, k: int, ptx: str, tail: str, n: int) -> str:
    nacc = n // 2
    outs = ", ".join(f"%{i}" for i in range(nacc))
    a = ", ".join(f"%{nacc + i}" for i in range(4))
    lines = [
        f"template <>\nstruct Wgmma<{ctype}, {n}> {{",
        "  __device__ static __forceinline__ void run(float* d, const "
        "uint32_t* a,",
        "                                             uint64_t desc, int "
        "scale_d) {",
        "    asm volatile(",
        '        "{\\n.reg .pred p;\\nsetp.ne.b32 p, '
        f'%{nacc + 5}, 0;\\n"',
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k{k}.f32.{ptx}.{ptx} "',
        f'        "{{{outs}}}, "',
        f'        "{{{a}}}, %{nacc + 4}, {tail};\\n}}\\n"',
        "        : " + ", ".join(f'"+f"(d[{i}])' for i in range(nacc)),
        '        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), '
        '"r"(scale_d));',
        "  }",
        "};",
    ]
    return "\n".join(lines)


def _wrapper_ss(ctype: str, k: int, ptx: str, tail: str, n: int,
                name: str = "WgmmaSS") -> str:
    nacc = n // 2
    outs = ", ".join(f"%{i}" for i in range(nacc))
    lines = [
        f"template <>\nstruct {name}<{ctype}, {n}> {{",
        "  __device__ static __forceinline__ void run(float* d, uint64_t "
        "desc_a,",
        "                                             uint64_t desc_b, int "
        "scale_d) {",
        "    asm volatile(",
        '        "{\\n.reg .pred p;\\nsetp.ne.b32 p, '
        f'%{nacc + 2}, 0;\\n"',
        f'        "wgmma.mma_async.sync.aligned.m64n{n}k{k}.f32.{ptx}.{ptx} "',
        f'        "{{{outs}}}, "',
        f'        "%{nacc}, %{nacc + 1}, {tail};\\n}}\\n"',
        "        : " + ", ".join(f'"+f"(d[{i}])' for i in range(nacc)),
        '        : "l"(desc_a), "l"(desc_b), "r"(scale_d));',
        "  }",
        "};",
    ]
    return "\n".join(lines)


def render() -> str:
    parts = [
        "// Written by gen_wgmma.py; do not edit.  wgmma.mma_async m64nNkK",
        "// with A (64 x K) in four 32-bit registers per thread (the mma.sync",
        "// A fragment of each warp's 16 rows), B (K x N) K-major in shared",
        "// memory through the descriptor `desc`, f32 accumulators d[N / 2];",
        "// scale_d = 0 overwrites d, 1 adds to it.  K = 16 for bf16, 8 for",
        "// TF32 (f32 registers, read as TF32).  WgmmaSS: the same with A",
        "// K-major in shared memory through the descriptor `desc_a`.",
        "// WgmmaSSTB (bf16): WgmmaSS with B MN-major (transposed): N",
        "// contiguous in shared memory, desc_b's leading byte offset the",
        "// stride of its swizzle atoms along N.",
        "#pragma once",
        "",
        "#include <cuda_bf16.h>",
        "#include <stdint.h>",
        "",
        "namespace rvsr {",
        "",
        "template <typename T, int N>",
        "struct Wgmma;",
        "",
        "template <typename T, int N>",
        "struct WgmmaSS;",
        "",
        "template <typename T, int N>",
        "struct WgmmaSSTB;",
        "",
    ]
    for ctype, k, ptx, tail, _ in TYPES:
        for n in WIDTHS:
            parts += [_wrapper(ctype, k, ptx, tail, n), ""]
    for ctype, k, ptx, _, tail in TYPES:
        for n in SS_WIDTHS:
            parts += [_wrapper_ss(ctype, k, ptx, tail, n), ""]
    ctype, k, ptx, _, tail = TYPES[0]
    for n in TB_WIDTHS:
        parts += [_wrapper_ss(ctype, k, ptx, tail[:-1] + "1", n,
                              "WgmmaSSTB"), ""]
    parts += ["}  // namespace rvsr", ""]
    return "\n".join(parts)


if __name__ == "__main__":
    HEADER.write_text(render())
