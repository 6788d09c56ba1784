"""channelize.ms: the program's StageTimer part "channelize" (the
channelizer, the channel selection and a synchronize), mean per window
of the traced window."""


def read(trace):
    v = trace["spans"].get("stage.channelize")
    return sum(v) / len(v) if v else None
