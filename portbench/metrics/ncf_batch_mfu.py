"""The tower FLOPs of every query answered in the window over the window
times the card's float32 peak."""

from portbench import work


def read(run):
    st = run.stats
    pk = work.peaks(run.device_name)
    if pk is None or not st.get("queries"):
        return None
    flops = st["queries"] * st["items"] * work.ncf_pair_flops(
        st["table_width"], st["mlp"], st["item_bias"])
    return 100.0 * flops / (run.window_s * pk[1])
