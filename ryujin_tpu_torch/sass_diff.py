"""Compare the SASS of the kernel instances two kernel libraries share.

    python -m ryujin_tpu_torch.sass_diff OLD.so NEW.so

OLD.so and NEW.so are libraries that `kernels/build.py` built from two
checkouts (ryujin_tpu_torch/_build/libryujin_kernels_*.so).  Each kernel
instance of OLD is matched with the instance of NEW that has the same
kernel and template arguments; an instance of NEW whose trailing boolean
template argument is the dG flag matches OLD's instance without it when
the flag is false, and is left out when it is true; likewise a trailing
statics accessor argument: FullStatics is dropped, an instance with
SepStatics (the separable statics) is left out of that pairing.  The
instances it leaves out (dG, SEP) are then paired by their mangled names
where both libraries have them.  Constant-bank
addresses of the form c[0x0][0x...] (the launch's parameters) are masked
before the comparison.  The stage-taking kernels (STAGED) end their
template arguments with the most stage slots an instance takes: the
instance of 2 matches OLD's instance without that argument, in both
pairings; the instance of 4 (ERK54's) has no match in a library built
before it.  Prints, for each pair, the instruction counts and the
instructions that still differ.  Needs cuobjdump (the CUDA toolkit's,
under $CUDA_HOME/bin).
"""

from __future__ import annotations

import re
import subprocess
import sys

from .kernels.build import cuda_tool

# kernels whose last template argument is the dG flag, and how many
# boolean template arguments they have with it
DG_FLAGGED = {"pk2_kernel": 1, "pk3_kernel": 1, "pk2_stream_kernel": 2,
              "pk3_stream_kernel": 2}


def listing(lib: str):
    """{mangled name: [(address, instruction text)]} of every kernel in
    `lib`, from cuobjdump -sass."""
    out = subprocess.run([str(cuda_tool("cuobjdump")), "-sass", str(lib)],
                         capture_output=True, text=True, check=True).stdout
    res, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            res[cur] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if cur and m:
            res[cur].append((int(m.group(1), 16), m.group(2)))
    return res


def functions(lib: str):
    """{mangled name: [instruction text with direct parameter offsets
    masked]} of every kernel in `lib`."""
    return {
        name: [re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]", text)
               for _, text in code]
        for name, code in listing(lib).items()
    }


# kernels whose last template argument is the most stage slots an instance
# takes (MS in csrc/euler.cuh)
STAGED = ("pk2_kernel", "pk3_kernel", "pk2_stream_kernel",
          "pk2_stream_tile_kernel", "pk3_stream_kernel")
_MS = re.compile(r"Li(\d+)E$")

# the mangled statics accessor argument, ryujin::FullStatics<T> or
# ryujin::SepStatics<T>, last among the template arguments
_STATICS = re.compile(r"N(?:S_|6ryujin)\d+(Full|Sep)StaticsI[fd]EE$")


def key(name: str):
    """(kernel, template arguments) of a mangled kernel name, with a false
    dG flag and a FullStatics accessor dropped; None for a dG or a SepStatics
    instance or a name of another form; an instance of at most 2 stage
    slots loses that argument, one of 4 gives None."""
    m = re.match(r"_ZN6ryujin\d+(\w+?_kernel)I(.*?)EEvPK", name)
    if not m:
        return None
    kernel, args = m.groups()
    if kernel in STAGED:
        ms = _MS.search(args)
        if ms and ms.group(1) != "2":
            return None
        if ms:
            args = args[: ms.start()]
    st = _STATICS.search(args)
    if st:
        if st.group(1) == "Sep":
            return None
        args = args[: st.start()]
    if args.count("Lb") == DG_FLAGGED.get(kernel):
        if args.endswith("Lb1E"):
            return None
        args = args[: -len("Lb0E")]
    return kernel, args


def without_two_slots(name: str) -> str:
    """A mangled name with the trailing template argument 2 of a STAGED
    kernel's instance of at most 2 stage slots taken out (the name it had
    before the kernels took more slots); any other name as it is."""
    m = re.match(r"_ZN6ryujin\d+(\w+?_kernel)I(.*?)EEvPK", name)
    if m and m.group(1) in STAGED and m.group(2).endswith("Li2E"):
        cut = m.end(2) - len("Li2E")
        return name[:cut] + name[m.end(2):]
    return name


def main():
    if len(sys.argv) != 3:
        sys.exit(__doc__)
    f_old, f_new = functions(sys.argv[1]), functions(sys.argv[2])
    old = {key(n): v for n, v in f_old.items() if key(n)}
    new = {key(n): v for n, v in f_new.items() if key(n)}
    # the instances key() leaves out, by mangled name, where both have them
    f_new = {without_two_slots(n): v for n, v in f_new.items()}
    for n in sorted(f_old):
        if not key(n) and n in f_new:
            old[("=", n)], new[("=", n)] = f_old[n], f_new[n]
    same = 0
    for k in sorted(old):
        a, b = old[k], new.get(k)
        if b is None:
            print(f"{k[0]} {k[1]}: not in {sys.argv[2]}")
            continue
        differing = [(i, x, y) for i, (x, y) in enumerate(zip(a, b)) if x != y]
        n_diff = len(differing) + abs(len(a) - len(b))
        same += n_diff == 0
        print(f"{k[0]:18s} {k[1]:14s} instructions {len(a):6d} / {len(b):6d},"
              f" differing {n_diff}")
        for i, x, y in differing:
            print(f"    {i:5d}: {x}  |  {y}")
    print(f"{same} of {len(old)} instances identical up to parameter offsets")


if __name__ == "__main__":
    main()
