"""chip_smoke.py's profiler windows read the same way whether or not the
profiler kept a device record.

Late in a long process a ``torch.profiler`` window can keep no device
record at all.  ``device_breakdown`` then reports the device time as not
measured; the phases that read its result (phase 14's remat windows,
phase 18's gpipe runs) still find ``window_complete``, ``launch_calls``
and ``lost_records``.  On the CPU every window is such a window, so these
tests drive the empty case here.
"""

import torch

import chip_smoke


def empty_window():
    with chip_smoke.profile_window() as prof:
        torch.ones(8).add_(1)
    return prof


def test_device_breakdown_of_a_window_without_device_records():
    b = chip_smoke.device_breakdown(empty_window(), 1, 1.0, "flash_attention",
                                    chip_smoke.FLASH_MARKERS, expected=12)
    assert b["device_time"].startswith("not measured")
    assert b["window_complete"] is False
    assert b["launch_calls"] == 0 and b["lost_records"] == 0
    assert b.get("device_busy_ms_per_step") is None


def test_remat_window_loop_reads_an_empty_window():
    """Phase 14's loop over windows: a window with no device record is an
    incomplete one, so the loop goes on to the next and ends without one."""
    res = {}
    for window in range(1, 3):
        res["profile"] = chip_smoke.device_breakdown(
            empty_window(), 1, 1.0, "flash_attention", chip_smoke.FLASH_MARKERS, expected=12)
        res["profile"]["window"] = window
        if res["profile"]["window_complete"]:
            break
    assert res["profile"]["window"] == 2
