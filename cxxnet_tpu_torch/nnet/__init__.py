"""The functional net, snapshots and the (serve-side) trainer."""
