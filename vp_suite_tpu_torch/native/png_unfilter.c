/* PNG row un-filtering (PNG specification, section 9: filter method 0).
 *
 * The inflated image data of a non-interlaced PNG is `height` rows, each one
 * filter-type byte followed by `stride` filtered bytes. Each byte is
 * reconstructed from the filtered byte x, the reconstructed byte one pixel to
 * the left a (`bpp` bytes back), the one above b and the one above-left c,
 * all 0 outside the image:
 *   0 None     x
 *   1 Sub      x + a
 *   2 Up       x + b
 *   3 Average  x + floor((a + b) / 2)
 *   4 Paeth    x + the one of a, b, c nearest to a + b - c (ties: a, then b)
 * modulo 256. Sub, Average and Paeth depend on the byte just reconstructed,
 * so each row is one sequential pass.
 *
 * Built at first use by native/build.py, into one library with
 * mmnist_gen.c, and loaded with ctypes (utils/image_io.py).
 */
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

/* data: height * (1 + stride) bytes; out: height * stride bytes.
 * Returns 0, or 1 + the index of the first row whose filter type is not 0-4. */
int64_t png_unfilter(const uint8_t *data, int64_t height, int64_t stride, int bpp,
                     uint8_t *out) {
    for (int64_t y = 0; y < height; y++) {
        const uint8_t *src = data + y * (stride + 1);
        int type = src[0];
        src++;
        uint8_t *row = out + y * stride;
        const uint8_t *up = y > 0 ? row - stride : NULL;
        int64_t i;
        switch (type) {
        case 0:
            memcpy(row, src, (size_t)stride);
            break;
        case 1:
            for (i = 0; i < bpp && i < stride; i++) row[i] = src[i];
            for (; i < stride; i++) row[i] = (uint8_t)(src[i] + row[i - bpp]);
            break;
        case 2:
            if (up)
                for (i = 0; i < stride; i++) row[i] = (uint8_t)(src[i] + up[i]);
            else
                memcpy(row, src, (size_t)stride);
            break;
        case 3:
            for (i = 0; i < stride; i++) {
                int a = i >= bpp ? row[i - bpp] : 0;
                int b = up ? up[i] : 0;
                row[i] = (uint8_t)(src[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (i = 0; i < stride; i++) {
                int a = i >= bpp ? row[i - bpp] : 0;
                int b = up ? up[i] : 0;
                int c = (up && i >= bpp) ? up[i - bpp] : 0;
                row[i] = (uint8_t)(src[i] + paeth(a, b, c));
            }
            break;
        default:
            return y + 1;
        }
    }
    return 0;
}
