"""The whole step's share of the card's peak over the traced window: the
least time the model's own work there could take (dense projections as
int8 at 1,979 TOP/s, attention and a bf16 unembedding at 989 TFLOP/s in
serving; 6 x parameters x tokens plus attention at 989 TFLOP/s in
training, recomputation not counted), over the window's wall time."""

LAYER = "Whole step"
UNIT = "%"
SOURCE = "device_trace"
MOVES = {"itl": "itl_p95_ms", "tput": "output_tokens_per_s",
         "train": "train_tokens_per_s"}


def read(run, name):
    tr = run.trace
    if not tr or tr["window_s"] <= 0:
        return None
    w = run.work
    if run.kind == "train":
        least = sum(w.train_least_s(rows, seq) for rows, seq in tr["steps"])
    else:
        least = sum(w.prefill_least_s(lens) for *_, lens in tr["prefills"])
        least += sum(w.decode_least_s(lens[active].tolist())
                     for _, lens, active in tr["decodes"])
    return 100.0 * least / tr["window_s"]
