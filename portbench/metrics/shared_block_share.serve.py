"""shared_block_share.serve: the share of the window's prefill device time
launched inside the program's ``shared`` spans (the shared attention+MLP
block invocations, concat to linear), in %; lower is better, since
faster shared blocks take a smaller share. Each kernel or copy is put
down to the launching span it starts after (``lm_trace.owners``); of
those that fall to ``prefill.forward``, the ones that start inside a
``shared`` span of it count (``lm_trace.spans_named``). That is exact
where the card keeps up with the host. Where the host runs ahead, as in
zamba2-docs' prefill, an op launched inside a span can start after the
span ends, so the reading moves from the blocks' share of the device
time toward their share of the host's: on one H100 (700 W) it read
18.8-19.6% where CUDA events around the blocks of a 2,700-token prefill
give 21.5%, 2-3 points low. The device trace's records carry no launch
correlation id, which would make it exact. A program without the spans
gives nothing."""
import bisect

from portbench import lm_trace


def read(run):
    lm = lm_trace.of(run)
    if lm is None or not run.kernels:
        return None
    ks = [k for k in run.kernels if run.t0 <= k[1] <= run.t1]
    owner = lm_trace.owners(lm, [k[1] for k in ks])
    prefill = [k for k, o in zip(ks, owner)
               if o is not None and o[0] == "prefill.forward"]
    shared = lm_trace.spans_named(lm, ("shared",))
    if not prefill or not shared:
        return None
    begin = [s[1] for s in shared]

    def inside(t):
        i = bisect.bisect_right(begin, t) - 1
        return i >= 0 and t <= shared[i][2]

    total = sum(b - a for _, a, b in prefill)
    part = sum(b - a for _, a, b in prefill if inside(a))
    return 100.0 * part / total if total > 0 else None
