"""The least time of a full wave on this card over a wave's device time."""

from portbench import work


def read(run):
    st = run.stats
    if not st.get("wave_device_s") or not st.get("waves"):
        return None
    least = work.least_seconds(work.ncf_wave_least_work(
        st["wave_queries"], st["items"], st["table_width"], st["mlp"],
        st["k"], st["item_bias"]), run.device_name)
    if least is None:
        return None
    return 100.0 * least / (st["wave_device_s"] / st["waves"])
