"""Forward and backward FLOPs (three times the forward) of every scored
pair trained in the window over the window times the card's float32
peak."""

from portbench import work


def read(run):
    st = run.stats
    pk = work.peaks(run.device_name)
    if pk is None or not st.get("positives"):
        return None
    flops = work.ncf_train_step_flops(
        st["positives"], st["negatives_per_positive"], st["table_width"],
        st["mlp"], st["item_bias"])
    return 100.0 * flops / (run.window_s * pk[1])
