"""The benchmark's yardstick: traffic, weights, the reduction of traces to
metrics, the table of peaks, the operations and bytes of each kernel's
function, and the comparison that decides ``correct``."""
