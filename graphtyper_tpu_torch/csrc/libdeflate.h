/* Declarations of the eight libdeflate calls that the C++ engine
 * (native/gt_native.cpp) makes, with libdeflate's own names, types and
 * result codes. The port compiles the engine against this header, so a host
 * needs neither libdeflate's headers nor its library to build it; the engine
 * links csrc/libdeflate_zlib.c's library (SONAME libdeflate.so.0), and at run
 * time graphtyper_tpu_torch/host.py loads the system libdeflate.so.0 or that
 * stand-in under the same name.
 */
#ifndef GT_LIBDEFLATE_DECLS_H
#define GT_LIBDEFLATE_DECLS_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

enum libdeflate_result {
  LIBDEFLATE_SUCCESS = 0,
  LIBDEFLATE_BAD_DATA = 1,
  LIBDEFLATE_SHORT_OUTPUT = 2,
  LIBDEFLATE_INSUFFICIENT_SPACE = 3,
};

struct libdeflate_compressor;
struct libdeflate_decompressor;

struct libdeflate_decompressor *libdeflate_alloc_decompressor(void);
void libdeflate_free_decompressor(struct libdeflate_decompressor *d);
enum libdeflate_result libdeflate_gzip_decompress_ex(struct libdeflate_decompressor *d,
                                                     const void *in, size_t in_nbytes,
                                                     void *out, size_t out_nbytes_avail,
                                                     size_t *actual_in_nbytes_ret,
                                                     size_t *actual_out_nbytes_ret);
struct libdeflate_compressor *libdeflate_alloc_compressor(int compression_level);
void libdeflate_free_compressor(struct libdeflate_compressor *c);
size_t libdeflate_deflate_compress_bound(struct libdeflate_compressor *c, size_t in_nbytes);
size_t libdeflate_deflate_compress(struct libdeflate_compressor *c, const void *in,
                                   size_t in_nbytes, void *out, size_t out_nbytes_avail);
uint32_t libdeflate_crc32(uint32_t crc, const void *buffer, size_t len);

#ifdef __cplusplus
}
#endif

#endif
