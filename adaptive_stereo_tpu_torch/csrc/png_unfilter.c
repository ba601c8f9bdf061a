/* Undo the row filters of a PNG image, in place, on the host.
 *
 * data holds h rows of 1 + stride bytes as they come out of inflate: a
 * filter-type byte, then the row's filtered bytes; bpp is the bytes of one
 * pixel (at least 1). Each row becomes the image's bytes (its filter byte
 * is left as it is). Returns 0, or the first filter type above 4.
 *
 * Built with the host's C compiler by data/png.py and called through
 * ctypes, which releases the GIL for the call, so the loader's threads
 * decode while the adaptation step runs on the main thread.
 */
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

int png_unfilter(uint8_t *data, int h, int stride, int bpp) {
    for (int y = 0; y < h; ++y) {
        uint8_t *row = data + (size_t)y * (size_t)(stride + 1);
        const int kind = row[0];
        uint8_t *cur = row + 1;
        /* The row above, already undone; none above the first row. */
        const uint8_t *up = y ? cur - (stride + 1) : NULL;
        if (kind > 4) return kind;
        for (int i = 0; i < stride; ++i) {
            const int a = i >= bpp ? cur[i - bpp] : 0;
            const int b = up ? up[i] : 0;
            const int c = (up && i >= bpp) ? up[i - bpp] : 0;
            int pred = 0;
            if (kind == 1) {
                pred = a;
            } else if (kind == 2) {
                pred = b;
            } else if (kind == 3) {
                pred = (a + b) >> 1;
            } else if (kind == 4) {
                const int pa = abs(b - c), pb = abs(a - c), pc = abs(a + b - 2 * c);
                pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            }
            cur[i] = (uint8_t)(cur[i] + pred);
        }
    }
    return 0;
}
