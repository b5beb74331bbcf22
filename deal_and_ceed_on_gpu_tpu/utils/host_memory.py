"""Host allocator tuning for slow-fault virtualized dev boxes.

Measured on the round-3 dev box (Firecracker VM, memory served through a
VMM fault handler): FRESH anonymous pages fault in at ~25-90 MB/s
(~140 us per 4 KB page), while warm pages stream at 2-4.5 GB/s. glibc
releases every large (> mmap threshold) buffer back to the OS on free,
so each large numpy allocation pays the slow fault path again — host
geometry setup on a 1M-DoF mapped mesh spent ~80 s in page faults for
~2 s of arithmetic.

``tune_host_allocator`` raises glibc's mmap/trim thresholds so large
buffers live on the brk heap and stay resident across malloc/free
cycles: the fault cost is paid once per high-water mark, and repeated
table builds / solver setups run at warm-memory speed (measured 70x on
repeated 151 MB alloc+fill cycles). numpy's own THP madvise
(``MADV_HUGEPAGE`` on >= 4 MB buffers, on by default) composes with
this. No-op on non-glibc platforms.

The algorithmic half of the fix lives in ``geometry.py``: mapped-mesh
setup streams z-slabs and materializes only the tables consumers need
(first-touch bytes, not FLOPs, dominate there).
"""

from __future__ import annotations

__all__ = ["tune_host_allocator"]

_done = False


def tune_host_allocator(
    mmap_threshold: int = 1 << 30, trim_threshold: int = 1 << 30
) -> bool:
    """Idempotent; returns True if glibc accepted the thresholds.

    Process-global: raised thresholds keep freed large buffers on the brk
    heap (peak-RSS-sized heap stays resident for the process lifetime).
    That is the right trade on slow-fault virtualized hosts where this
    framework owns the process, but embedding applications can opt out by
    setting ``DCG_MALLOPT=0`` before import."""
    global _done
    if _done:
        return True
    import os

    if os.environ.get("DCG_MALLOPT", "1") == "0":
        return False
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_MMAP_THRESHOLD, M_TRIM_THRESHOLD = -3, -1
        ok = bool(libc.mallopt(M_MMAP_THRESHOLD, mmap_threshold)) and bool(
            libc.mallopt(M_TRIM_THRESHOLD, trim_threshold)
        )
        _done = ok
        return ok
    except Exception:
        return False
