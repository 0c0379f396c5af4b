// Parallel inflate for plain single-member gzip (pugz-style speculation).
// See gz_parallel.cpp. Returns true and fills `out` with the complete
// inflated stream ONLY when every speculative chunk decoded consistently
// AND the gzip footer CRC32 + ISIZE verify; any other outcome returns
// false and the caller must use the serial path. Never throws.
#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace bronko_gzp {

bool parallel_inflate(const uint8_t* in, size_t n, std::vector<char>& out);

// successful parallel inflates this process (tests assert the fast path
// actually ran rather than silently falling back)
int64_t runs();

}  // namespace bronko_gzp
