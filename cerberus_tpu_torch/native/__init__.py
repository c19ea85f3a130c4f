"""Host-side native code, loaded with ctypes: the threaded C++ patch gather
(``patch_gather``) that ``NpyPyramidReader.read_batch`` feeds the legacy WSI
loop with."""
