/* The eight libdeflate entry points that the C++ engine (native/*.cpp, as
 * the port builds it in io/native.py) calls, implemented over zlib, for
 * hosts that have zlib but no libdeflate.so.0. Built with the SONAME
 * libdeflate.so.0: the engine links this library, so its DT_NEEDED entry is
 * libdeflate.so.0, and host.py loads the system library or this one under
 * that name before the engine.
 *
 * Decompression is exact: one gzip member per call, as libdeflate does.
 * Compression writes valid raw DEFLATE streams whose bytes differ from
 * libdeflate's; every reader decompresses them to the same data.
 */

#include <limits.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <zlib.h>

#include "libdeflate.h"

struct libdeflate_decompressor {
  int unused;
};

struct libdeflate_compressor {
  int level;
};

struct libdeflate_decompressor *libdeflate_alloc_decompressor(void)
{
  return (struct libdeflate_decompressor *)calloc(1, sizeof(struct libdeflate_decompressor));
}

void libdeflate_free_decompressor(struct libdeflate_decompressor *d)
{
  free(d);
}

enum libdeflate_result libdeflate_gzip_decompress_ex(struct libdeflate_decompressor *d,
                                                     const void *in, size_t in_nbytes,
                                                     void *out, size_t out_nbytes_avail,
                                                     size_t *actual_in_nbytes_ret,
                                                     size_t *actual_out_nbytes_ret)
{
  (void)d;
  z_stream s;
  memset(&s, 0, sizeof s);
  if (inflateInit2(&s, 16 + MAX_WBITS) != Z_OK)
    return LIBDEFLATE_BAD_DATA;
  s.next_in = (Bytef *)in;
  s.avail_in = in_nbytes > UINT_MAX ? UINT_MAX : (uInt)in_nbytes;
  s.next_out = (Bytef *)out;
  s.avail_out = out_nbytes_avail > UINT_MAX ? UINT_MAX : (uInt)out_nbytes_avail;
  const int rc = inflate(&s, Z_FINISH); /* stops at the end of the first member */
  const size_t used_in = s.total_in;
  const size_t produced = s.total_out;
  inflateEnd(&s);
  if (rc != Z_STREAM_END)
  {
    if ((rc == Z_BUF_ERROR || rc == Z_OK) && produced == out_nbytes_avail)
      return LIBDEFLATE_INSUFFICIENT_SPACE;
    return LIBDEFLATE_BAD_DATA;
  }
  if (actual_in_nbytes_ret)
    *actual_in_nbytes_ret = used_in;
  if (actual_out_nbytes_ret)
    *actual_out_nbytes_ret = produced;
  else if (produced != out_nbytes_avail)
    return LIBDEFLATE_SHORT_OUTPUT;
  return LIBDEFLATE_SUCCESS;
}

struct libdeflate_compressor *libdeflate_alloc_compressor(int level)
{
  if (level < 0 || level > 12)
    return NULL;
  struct libdeflate_compressor *c =
    (struct libdeflate_compressor *)malloc(sizeof(struct libdeflate_compressor));
  if (c)
    c->level = level > 9 ? 9 : level;
  return c;
}

void libdeflate_free_compressor(struct libdeflate_compressor *c)
{
  free(c);
}

/* An upper bound on zlib's raw DEFLATE output for any input of this size:
 * stored blocks cost 5 bytes per 16 KiB, the bound below allows more. */
size_t libdeflate_deflate_compress_bound(struct libdeflate_compressor *c, size_t in_nbytes)
{
  (void)c;
  return in_nbytes + (in_nbytes >> 3) + (in_nbytes >> 6) + 64;
}

/* Raw DEFLATE of `in` into `out`; the compressed size, or 0 when it does
 * not fit in out_nbytes_avail (libdeflate's contract). */
size_t libdeflate_deflate_compress(struct libdeflate_compressor *c, const void *in,
                                   size_t in_nbytes, void *out, size_t out_nbytes_avail)
{
  if (in_nbytes > UINT_MAX || out_nbytes_avail == 0)
    return 0;
  z_stream s;
  memset(&s, 0, sizeof s);
  if (deflateInit2(&s, c->level, Z_DEFLATED, -MAX_WBITS, 8, Z_DEFAULT_STRATEGY) != Z_OK)
    return 0;
  s.next_in = (Bytef *)in;
  s.avail_in = (uInt)in_nbytes;
  s.next_out = (Bytef *)out;
  s.avail_out = out_nbytes_avail > UINT_MAX ? UINT_MAX : (uInt)out_nbytes_avail;
  const int rc = deflate(&s, Z_FINISH);
  const size_t produced = s.total_out;
  deflateEnd(&s);
  return rc == Z_STREAM_END ? produced : 0;
}

uint32_t libdeflate_crc32(uint32_t crc, const void *buffer, size_t len)
{
  const Bytef *p = (const Bytef *)buffer;
  while (len > 0)
  {
    const uInt n = len > UINT_MAX ? UINT_MAX : (uInt)len;
    crc = (uint32_t)crc32(crc, p, n);
    p += n;
    len -= n;
  }
  return crc;
}
