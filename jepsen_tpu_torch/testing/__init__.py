"""History generators for the smoke run and the tests."""
