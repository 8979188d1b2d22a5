"""The benchmark's yardstick: traffic, statistics, costs, traces."""
