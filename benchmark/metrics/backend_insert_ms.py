"""Device milliseconds per keyframe insert: the kernels and copies launched
while the benchmark's span around local_mapping.backend_insert was open
(matched to their launch by correlation id), per call.  The insert is
queued asynchronously, so this is device time, not the host's wall."""


def read(td):
    per = td.device_ns_under("local_mapping.backend_insert")
    if not per:
        return None
    return sum(per) / len(per) / 1e6
