"""Emit saf_default_hrirs.c for the reference build.

The reference snapshot declares __default_hrirs et al.
(framework/modules/saf_hrir/saf_hrir.h:49-61) but the data file is absent.
We emit it from our synthesised rigid-sphere set (data/default_hrirs.npz,
produced by tools/gen_default_hrirs.py) so the compiled C reference and the
JAX framework use the *same* HRIR data — making ambi_bin goldens directly
comparable.
"""
import sys

import numpy as np

NPZ = "/root/repo/spatial_audio_framework_tpu/data/default_hrirs.npz"


def main(out_path: str) -> None:
    d = np.load(NPZ)
    hrirs = d["hrirs"].astype(np.float32)          # (836, 2, 256)
    dirs = d["dirs_deg"].astype(np.float32)        # (836, 2)
    fs = int(d["fs"])
    n, _, length = hrirs.shape

    with open(out_path, "w") as f:
        f.write("/* generated by gen_default_hrirs_c.py */\n")
        f.write(f"const int __default_N_hrir_dirs = {n};\n")
        f.write(f"const int __default_hrir_len = {length};\n")
        f.write(f"const int __default_hrir_fs = {fs};\n")
        f.write(f"const float __default_hrirs[{n}][2][{length}] = {{\n")
        for i in range(n):
            f.write("{")
            for e in range(2):
                vals = ",".join(f"{v:.8e}f" for v in hrirs[i, e])
                f.write("{" + vals + "},")
            f.write("},\n")
        f.write("};\n")
        f.write(f"const float __default_hrir_dirs_deg[{n}][2] = {{\n")
        for i in range(n):
            f.write(f"{{{dirs[i,0]:.6f}f,{dirs[i,1]:.6f}f}},\n")
        f.write("};\n")


if __name__ == "__main__":
    main(sys.argv[1])
