"""Share of the frames the chunked tracker (tracking.track_chunk) tracked
and then threw away to track again (System.n_frames_discarded over
n_frames_chunked, summed over the traced window's sessions), in percent."""


def read(td):
    chunked = td.outcome.counter("n_frames_chunked")
    discarded = td.outcome.counter("n_frames_discarded")
    if not chunked:
        return None
    return 100.0 * discarded / chunked
