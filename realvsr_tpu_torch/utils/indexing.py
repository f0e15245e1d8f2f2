"""Temporal window index generation for sliding-window video inference.

Mirrors the reference ``codes/data/util.py:169-252`` exactly (the padding
modes drive the test-time frame windows and must match for parity).
"""
from __future__ import annotations


def index_generation(crt_i: int, max_n: int, n_frames: int,
                     padding: str = "reflection") -> list[int]:
    """Indices of ``n_frames`` frames centered at ``crt_i``.

    padding: replicate | reflection | new_info | circle.
      Example crt_i=0, N=5: replicate [0,0,0,1,2]; reflection [2,1,0,1,2];
      new_info [4,3,0,1,2]; circle [3,4,0,1,2].
    """
    max_n = max_n - 1
    n_pad = n_frames // 2
    out = []
    for i in range(crt_i - n_pad, crt_i + n_pad + 1):
        if i < 0:
            if padding == "replicate":
                add_idx = 0
            elif padding == "reflection":
                add_idx = -i
            elif padding == "new_info":
                add_idx = (crt_i + n_pad) + (-i)
            elif padding == "circle":
                add_idx = n_frames + i
            else:
                raise ValueError("Wrong padding mode")
        elif i > max_n:
            if padding == "replicate":
                add_idx = max_n
            elif padding == "reflection":
                add_idx = max_n * 2 - i
            elif padding == "new_info":
                add_idx = (crt_i - n_pad) - (i - max_n)
            elif padding == "circle":
                add_idx = i - n_frames
            else:
                raise ValueError("Wrong padding mode")
        else:
            add_idx = i
        out.append(add_idx)
    return out


def index_generation_with_scene_list(crt_i: int, max_n: int, n_frames: int,
                                     scene_list: list[int],
                                     padding: str = "replicate") -> list[int]:
    """Scene-aware variant (data/util.py:217-252); replicate padding only."""
    assert max_n == scene_list[-1]
    n_pad = n_frames // 2
    out = []
    for i in range(len(scene_list) - 1):
        if scene_list[i] <= crt_i <= scene_list[i + 1] - 1:
            for j in range(crt_i - n_pad, crt_i + n_pad + 1):
                if j < scene_list[i]:
                    if padding != "replicate":
                        raise ValueError("Wrong padding mode")
                    add_idx = scene_list[i]
                elif j > scene_list[i + 1] - 1:
                    if padding != "replicate":
                        raise ValueError("Wrong padding mode")
                    add_idx = scene_list[i + 1] - 1
                else:
                    add_idx = j
                out.append(add_idx)
    return out
