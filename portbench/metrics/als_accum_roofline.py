"""Kernel 1's least time over its device time per launch: the profiler's
time of its two device functions (``accum_fused``, ``reduce_carries``)
over its launches, against the least work of a half-step counted from the
ratings, averaged over the user and the item half-steps."""

from portbench import work


def read(run):
    st, tr = run.stats, run.trace
    if tr is None or not st.get("nnz"):
        return None
    fused_s, launches = tr.kernel("accum_fused")
    carry_s, _ = tr.kernel("reduce_carries")
    if not launches:
        return None
    k, nnz = st["rank"], st["nnz"]
    least = [work.least_seconds(work.als_accum_least_work(nnz, k, seg, oth),
                                run.device_name)
             for seg, oth in ((st["users"], st["items"]),
                              (st["items"], st["users"]))]
    if None in least:
        return None
    return 100.0 * (sum(least) / 2) * launches / (fused_s + carry_s)
