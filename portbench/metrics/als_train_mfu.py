"""Both half-steps' accumulation FLOPs and the solves' of every iteration
in the window over the window times the card's float32 peak."""

from portbench import work


def read(run):
    st = run.stats
    pk = work.peaks(run.device_name)
    if pk is None or not st.get("iterations"):
        return None
    flops = st["iterations"] * work.als_iteration_flops(
        st["nnz"], st["rank"], st["users"], st["items"])
    return 100.0 * flops / (run.window_s * pk[1])
