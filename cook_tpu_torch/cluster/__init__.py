"""The compute-cluster boundary and the in-memory mock backend."""
